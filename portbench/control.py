"""Readings of the check's number, the table's gap, from which its limit
is set: the program's on sound runs, and the controls'.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3

For each seed, in one process: the cell's inputs, one call of the timed
path (the window's own call, at the cell's size), the float64 reference,
and two controls, each held to the float64 reference as the program is:

* ``reference_f32``: the reference put in the program's place and
  computed in float32, the precision below the configuration's float64
  statistics;
* ``program_dense``: the program with its own lower-precision path
  switched on (``bh_backend='host'``: the dense scorer, whose O, ICE and
  Fold are the device's float32, as JAX's dense route emits them).

One JSON line a seed, on the card, as the benchmark runs; the tests call
:func:`readings` on the CPU.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(cell, seed, device):
    """{gap name: (gap, where)} of one seed (:mod:`portbench.driver`)."""
    import numpy as np
    import torch
    from portbench import driver
    entry = driver.make_entry(cell.root, cell.config, cell.traffic, seed,
                              device)
    entry.setup()
    out, got = {}, {}
    t0 = time.perf_counter()
    got['program'] = entry.step()
    got['program_dense'] = entry.step(bh_backend='host')
    out['program_s'] = time.perf_counter() - t0
    entry.free()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = entry.reference()
    out['reference_s'] = time.perf_counter() - t0
    got['reference_f32'] = entry.reference(np.float32)
    for name, table in got.items():
        gap, where = entry.gap(table, want)
        out[name] = gap
        out[f'{name}.where'] = repr(where)
    out['peaks'] = _count(want)
    return out


def _count(table):
    first = next(iter(table.values()), None)
    if isinstance(first, dict):
        return sum(len(t) for t in table.values())
    return len(table)


def main(argv=None):
    import argparse
    import torch
    from portbench.harness import Cell
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    cell = Cell(ROOT, args.workload)
    device = torch.device('cuda', 0)
    for seed in args.seeds:
        rec = readings(cell, seed, device)
        print(json.dumps(dict(workload=args.workload, seed=seed, **rec)),
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
