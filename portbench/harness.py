"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, and the result line.

Everything that belongs to one cell is found by name under the root that
holds ``BENCHMARK.json``: the configuration at its ``file``, the traffic
mix at ``portbench/traffic/<traffic>.json`` with its entry at
``portbench/mixes/<entry>.py`` (:mod:`portbench.driver`), and each
metric's reader at ``portbench/metrics/<metric>.py``.  A reader is a module with
``read(run) -> number or None``; a reader that finds nothing to read
returns None and its metric is left out of the line.

With ``trace`` the window is the mix's ``trace_steps`` calls under
``torch.profiler`` (host and device), after one discarded capture in
set-up that pays CUPTI's start-up; the benchmark's own spans time the
engine's float64 completion and clustering, and the line holds the cell's
per-layer metrics, the device's busy and window seconds, and the
breakdown.  Without it the window lasts ``seconds`` (its last call ends it)
and the line holds the cell's end-to-end metrics.
"""
from __future__ import annotations

import importlib.util
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time

from . import driver
from .trace import STEP, Trace

#: top-level modules the benchmark's process may not hold: JAX and the JAX
#: package (whose name the port's begins with)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'hicpeaks_tpu')


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` at ``root`` with its
    configuration, traffic mix and metric readers."""

    def __init__(self, root, name):
        self.root = root
        self.spec = load_json(os.path.join(root, 'BENCHMARK.json'))
        cells = {w['name']: w for w in self.spec['workloads']}
        if name not in cells:
            raise SystemExit(f'no workload {name!r} in BENCHMARK.json '
                             f'(workloads: {sorted(cells)})')
        self.workload = cells[name]
        configs = {c['name']: c for c in self.spec['configs']}
        self.config = load_json(os.path.join(
            root, configs[self.workload['config']]['file']))
        self.traffic = load_json(os.path.join(
            root, 'portbench', 'traffic', f'{self.workload["traffic"]}.json'))
        self.end_to_end = self._metrics('end_to_end')
        self.per_layer = self._metrics('per_layer')

    def _metrics(self, kind):
        return [m for m in self.spec[kind]
                if self.workload['name'] in m.get('workloads',
                                                  [self.workload['name']])]

    def reader(self, metric):
        path = os.path.join(self.root, 'portbench', 'metrics',
                            f'{metric["name"]}.py')
        return load_module(path, 'portbench_metric_' +
                           re.sub(r'\W', '_', metric['name']))


class Run:
    """What a metric reader reads: the steps' host walls, the window and
    set-up seconds, the entry (its shapes and settings) and, in a traced
    run, the Trace, the benchmark's spans a step and the program's log."""

    def __init__(self, cell, entry):
        self.cell, self.entry = cell, entry
        self.walls = []
        self.window_s = self.setup_s = None
        self.trace = None
        self.spans = {}
        self.log = []


class _Spans:
    """The benchmark's spans in a traced run: each wrapped function is
    timed on the host clock and marked ``portbench.<name>`` in the trace;
    seconds are summed by name."""

    def __init__(self, run):
        self.run, self.saved = run, []

    def wrap(self, module, attr, name):
        from torch.profiler import record_function
        real = getattr(module, attr)
        totals = self.run.spans.setdefault(name, [0.0])

        def timed(*args, **kw):
            with record_function(f'portbench.{name}'):
                t0 = time.perf_counter()
                try:
                    return real(*args, **kw)
                finally:
                    totals[0] += time.perf_counter() - t0
        self.saved.append((module, attr, real))
        setattr(module, attr, timed)

    def restore(self):
        for module, attr, real in reversed(self.saved):
            setattr(module, attr, real)


class _LogGrab(logging.Handler):
    def __init__(self, out):
        super().__init__(level=logging.INFO)
        self.out = out

    def emit(self, record):
        self.out.append(record.getMessage())


def forbidden_modules():
    return sorted({m.split('.')[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def no_forbidden_modules(when):
    """Raise if the process holds a module of FORBIDDEN (``when``: the
    point of the run, for the message)."""
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f'the process holds {bad} {when}')


def card_info(device):
    import torch
    if device.type != 'cuda':
        return dict(platform='cpu', kind='cpu', count=1)
    return dict(platform='gpu', kind=torch.cuda.get_device_name(device),
                count=1)


def power_limit():
    """The card's power limit in watts, as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _discard_capture(device):
    """One short profiler capture, thrown away: a process's first capture
    pays CUPTI's start-up (7-8 s on the H100 host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    with profile(activities=acts):
        torch.ones(8, device=device).sum().item()


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def measure(cell, seed, seconds, trace, device, t_start, patch=None):
    """Set up, measure and check one run of ``cell``; -> (result dict,
    check lines).  ``patch(entry)``, if given, is called after set-up
    (tests break the timed path with it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    entry = driver.make_entry(cell.root, cell.config, cell.traffic, seed,
                              device)
    run = Run(cell, entry)
    entry.setup()
    entry.step()                    # warm-up: builds every kernel it uses
    _sync(device)
    if patch is not None:
        patch(entry)
    spans = None
    if trace:
        _discard_capture(device)
        from hicpeaks_tpu_torch.core import engine
        spans = _Spans(run)
        spans.wrap(engine, '_compact_to_host', 'host_complete')
        spans.wrap(engine, '_bhfdr_to_host', 'host_complete')
        spans.wrap(engine, 'local_clustering', 'clustering')
        alog = logging.getLogger('hicpeaks_tpu_torch.api')
        grab, level = _LogGrab(run.log), alog.level
        alog.addHandler(grab)
        alog.setLevel(logging.INFO)
    run.setup_s = time.perf_counter() - t_start

    answers = []                    # [table, steps that returned it]
    t0 = time.perf_counter()
    try:
        if trace:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
            prof = profile(activities=acts)
            prof.start()
            try:
                for _ in range(int(cell.traffic['trace_steps'])):
                    with record_function(STEP):
                        ts = time.perf_counter()
                        table = entry.step()
                        run.walls.append(time.perf_counter() - ts)
                    _tally(answers, table)
            finally:
                prof.stop()
        else:
            while time.perf_counter() - t0 < seconds:
                ts = time.perf_counter()
                table = entry.step()
                run.walls.append(time.perf_counter() - ts)
                _tally(answers, table)
    finally:
        if spans is not None:
            spans.restore()
            alog.removeHandler(grab)
            alog.setLevel(level)
    run.window_s = time.perf_counter() - t0

    no_forbidden_modules('once the window has closed')
    dev = card_info(device)
    if device.type == 'cuda':
        dev['memory_peak_bytes'] = int(torch.cuda.max_memory_allocated(
            device))
        dev['power_limit_w'] = power_limit()
    if trace:
        with tempfile.TemporaryDirectory(prefix='portbench-trace-') as tdir:
            path = os.path.join(tdir, 'trace.json')
            prof.export_chrome_trace(path)
            del prof
            run.trace = Trace.load(path)
        dev['busy_s'] = run.trace.busy_us() / 1e6
        dev['window_s'] = run.trace.window_us / 1e6

    # the check, once the window has closed and the program's state is
    # freed: every distinct answer against the reference
    entry.free()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = entry.reference()
    reference_s = time.perf_counter() - t_ref
    # the configuration's limit on a table's gap (compare.table_gap), set
    # from the program's readings and the control's (PERF.md)
    limit = float(cell.config['gap_limit'])
    gaps = [(entry.gap(table, want), n) for table, n in answers]
    worst, where = max((g for g, _ in gaps), key=lambda g: g[0],
                       default=(1.0, 'no step'))
    failed = sum(n for (g, _), n in gaps if not g <= limit)
    attempted = len(run.walls)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m).read(run)
        if value is not None:
            metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
    result = {'correct': attempted > 0 and failed == 0,
              'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev}
    if trace:
        result['breakdown'] = {'device_ops': run.trace.top_device_ops(),
                               'idle_gaps': run.trace.idle_by_mark()}
    result['inputs'] = entry.inputs
    result['reference_s'] = reference_s
    result['distinct_answers'] = len(answers)
    result['checks'] = {'table_gap': {'value': worst, 'limit': limit}}
    no_forbidden_modules('after the reference and the metric readers')
    lines = [f'worst locus {where!r}', f'table_gap {worst!r} limit {limit!r}']
    return result, lines


def _tally(answers, table):
    """Count ``table`` among the distinct answers so far."""
    for rec in answers:
        if rec[0] == table:
            rec[1] += 1
            return
    answers.append([table, 1])


def main(argv=None, t_start=None):
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(
        description='Run one cell of the port\'s benchmark (BENCHMARK.json) '
        'and print its result as the last line.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = Cell(root, args.workload)

    import torch
    chips = int(cell.workload['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'portbench: the cell needs {chips} CUDA card(s); this '
              f'machine has {torch.cuda.device_count()} '
              f'(available: {torch.cuda.is_available()})', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    result, lines = measure(cell, args.seed, args.seconds, bool(args.trace),
                            device, t_start)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
