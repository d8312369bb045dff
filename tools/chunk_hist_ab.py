#!/usr/bin/env python3
"""Time the histogram kernel of this checkout against other builds of it
on one CUDA card.

    python3 tools/chunk_hist_ab.py --base DIR [--base DIR ...] [--reps 20]

Each ``DIR`` holds another tree of the repository (another commit,
unpacked with ``git archive`` into a git-ignored directory); its kernels
are built by ``kernels/build.build`` into ``build/ab/`` and named by the
directory's last component.  This checkout's build is ``new``.

It forms the histogram's inputs of ``chip_smoke.py``'s phase 7 at shapes
(a) (chr1, depth 40, o_cap 1024), (b) (chr1 at chip_smoke.DEEP_DEPTH,
o_cap 16384) and (c) ((b)'s ids, log-uniform counts, o_cap 131072), plus
(a) cut to n - 1 pixels (rows not 16-byte aligned).  For each shape it
prints where the increments fall (the share in cell (0, 0) and below each
count); every base must equal the plain twin, and ``new`` goes through
``chip_smoke.hist_check`` (twin, ``torch.bincount``, bound).  Then it
times each build through the package's wrapper (``cuda_hist.chunk_hist``,
the output's zero fill included), one call per CUDA-event sample as
``chip_smoke.py`` times it, in turns (bases, new, new, bases), and one
float32 ``torch.sum`` over the same input bytes (a yardstick of the card's
read rate).  It reports the median of all samples of both turns: one line
per shape and build, then one JSON line.
"""
import argparse
import functools
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COUNT_EDGES = (1, 2, 4, 8, 16, 64, 256, 518, 605, 726, 1024, 4096)


def where_counts(hist, S, B):
    """The share of all increments in cell (0, 0) of the backgrounds and
    below each count of COUNT_EDGES, and the nonzero cells."""
    import torch
    total = int(hist.sum())
    col = hist.sum(dim=0, dtype=torch.int64)
    cum = torch.cumsum(col, 0)
    zero = int(hist.reshape(B, S, -1)[:, 0, 0].sum())
    return dict(total=total, cell00=zero / total,
                below={e: int(cum[min(e, col.numel()) - 1]) / total
                       for e in COUNT_EDGES},
                nonzero_cells=int((hist != 0).sum()))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--base', action='append', default=[])
    ap.add_argument('--reps', type=int, default=20)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chunk_hist_ab: no CUDA device', file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hicpeaks_tpu_torch.kernels import build
    from hicpeaks_tpu_torch.ops import cuda_hist
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {}
    for d in args.base:
        libs[os.path.basename(os.path.normpath(d))] = build.KernelLibrary(
            *build.build(os.path.join(d, 'hicpeaks_tpu_torch', 'csrc'),
                         os.path.join(REPO, 'build', 'ab')))
    libs['new'] = build.load()
    for name, lib in libs.items():
        for line in lib.build_log.splitlines():
            if 'ptxas info' in line or 'spill' in line:
                print(f'  {name}: {line.strip()}', flush=True)
    kernels = {name: functools.partial(cuda_hist.chunk_hist, lib=lib)
               for name, lib in libs.items()}
    order = list(kernels)
    turns = order + order[::-1]
    device = 'cuda'

    a = cs.chr1_hist_streams(device, 40.0)
    b = cs.chr1_hist_streams(device, cs.DEEP_DEPTH)
    shapes = {'a': a,
              'a_n-1': dict(a, oc=a['oc'][:-1].contiguous(),
                            cid0=a['cid0'][:, :-1].contiguous()),
              'b': b, 'c': cs.cap_hist_streams(b, device)}
    report = {'card': smi, 'reps': args.reps, 'shapes': {}}
    for tag, st in shapes.items():
        oc, cid0, S, C = st['oc'], st['cid0'], st['S'], st['C']
        B, n = cid0.shape
        want = cuda_hist.chunk_hist_torch(oc, cid0, S, C)
        spread = where_counts(want, S, B)
        print(f'({tag}) increments {spread["total"]}: cell (0, 0) '
              f'{spread["cell00"]:.3f}; below count '
              + ', '.join(f'{e}: {f:.4f}' for e, f in spread['below'].items())
              + f'; {spread["nonzero_cells"]} nonzero cells', flush=True)
        for name in order[:-1]:
            if not torch.equal(kernels[name](oc, cid0, S, C), want):
                raise AssertionError(f'{name} differs from the twin at {tag}')
        del want
        rec = cs.hist_check(oc, cid0, S, C, args.reps, kernel=kernels['new'])
        samples = {name: [] for name in order}
        for name in turns:
            samples[name] += cs.cuda_samples(
                lambda: kernels[name](oc, cid0, S, C), args.reps)
        # a read-rate yardstick: one float32 torch.sum over the same bytes
        flat = torch.cat([oc, cid0.reshape(-1)]).view(torch.float32)
        sum_ms = cs.cuda_ms(lambda: flat.sum(), args.reps)
        del flat
        print(f'({tag}) torch.sum over the {4 * (oc.numel() + cid0.numel())}'
              f' input bytes: {sum_ms:.4f} ms; twin {rec["plain_ms"]:.3f} ms,'
              f' torch.bincount {rec["library_ms"]:.3f} ms', flush=True)
        rec.update(B=B, n=n, S=S, C=C, spread=spread, torch_sum_ms=sum_ms,
                   ms={}, turn_ms={})
        for name in order:
            ts = samples[name]
            rec['ms'][name] = statistics.median(ts)
            rec['turn_ms'][name] = [statistics.median(ts[:args.reps]),
                                    statistics.median(ts[args.reps:])]
            print(f'({tag}) B={B} n={n} S={S} C={C} {name}: '
                  f'{rec["ms"][name]:.4f} ms (turns '
                  f'{rec["turn_ms"][name][0]:.4f}, '
                  f'{rec["turn_ms"][name][1]:.4f}); bound '
                  f'{rec["bound_ms"]:.4f} ms, '
                  f'{rec["bound_ms"] / rec["ms"][name]:.1%} of it',
                  flush=True)
        report['shapes'][tag] = rec
    print(json.dumps(report))
    return 0


if __name__ == '__main__':
    sys.exit(main())
