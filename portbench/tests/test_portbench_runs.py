"""Whole runs of the harness on the CPU at tiny sizes (the look for a card
skipped): a sound run is correct, a run with its timed path broken
underneath is not, a cell added by new files alone runs, and the entry
point refuses to run without a card or without the program."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import PKG, REPO, make_root

CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp('root'))


def run(root, name, patch=None, trace=False, seed=11):
    cell = harness.Cell(root, name)
    res, lines = harness.measure(cell, seed, 0.2, trace, CPU,
                                 time.perf_counter(), patch=patch)
    return res, lines


def broken(entry, change):
    real = entry.fn

    def fn(*a, **kw):
        return change(real(*a, **kw))
    entry.fn = fn


def alter_one(table):
    """One answer altered where it is produced: the first peak's Fold
    moved by 1e-6 of itself."""
    out = dict(table)
    k = next(iter(out))
    row = out[k]
    out[k] = row[:4] + (row[4] * (1 + 1e-6),) + row[5:]
    return out


def drop_one(table):
    out = dict(table)
    out.pop(next(iter(out)))
    return out


@pytest.mark.parametrize('name', ['hiccups-k562-10kb.chr1',
                                  'bhfdr-k562-10kb.chr1'])
def test_chrom_cells_sound_and_broken(root, name):
    res, lines = run(root, name)
    assert res['correct'] and res['failed'] == 0 and res['attempted'] > 0
    check = res['checks']['table_gap']
    cell = harness.Cell(root, name)
    assert check['value'] <= check['limit'] == cell.config['gap_limit']
    assert list(res)[-1] == 'checks'
    assert lines[-1].startswith('table_gap ')
    want = {m['name'] for m in cell.end_to_end}
    assert set(res['metrics']) == want and {'setup_s', 'call_ms'} <= want
    for change in (alter_one, drop_one):
        res, _ = run(root, name, patch=lambda e: broken(e, change))
        assert not res['correct'], change.__name__
        assert res['failed'] == res['attempted'] > 0


def test_genome_cell_sound_and_broken(root):
    name = 'bhfdr-k562-10kb.genome'
    res, _ = run(root, name, trace=True)
    assert res['correct']
    assert {'producer_wait_pct.genome', 'band_build_s.genome'} <= \
        set(res['metrics'])
    assert res['device']['window_s'] > 0 and 'breakdown' in res

    def half(tables):       # half of the chromosomes left out
        keep = sorted(tables)[:len(tables) // 2]
        return {k: tables[k] for k in keep}

    def altered(tables):
        out = dict(tables)
        label = next(k for k, t in out.items() if t)
        out[label] = alter_one(out[label])
        return out
    for change in (half, altered):
        res, _ = run(root, name, patch=lambda e: broken(e, change))
        assert not res['correct'], change.__name__


def digest_tree(top):
    h = hashlib.sha256()
    for base, _, files in sorted(os.walk(top)):
        for f in sorted(files):
            if f.endswith('.pyc'):
                continue
            path = os.path.join(base, f)
            h.update(path.encode())
            with open(path, 'rb') as fh:
                h.update(fh.read())
    return h.hexdigest()


#: a new mix entry: each step calls the engine on one of the traffic's
#: chromosomes in turn, and the answer is the table of that chromosome
TURNS = '''
from ..mixes.chrom import ChromEntry


class Turns(ChromEntry):
    def setup(self):
        self.entries = []
        for label in self.traffic['chroms']:
            e = ChromEntry(self.root, self.config, dict(self.traffic,
                           chrom=label), self.seed, self.device)
            e.setup()
            self.entries.append(e)
        self.shape, self.turn = self.entries[0].shape, 0
        self.inputs = {}

    def step(self, **kw):
        e = self.entries[self.turn % len(self.entries)]
        self.turn += 1
        return {e.label: e.step(**kw)}

    def free(self):
        for e in self.entries:
            e.free()

    def reference(self, dtype=None):
        return {e.label: e.reference() for e in self.entries}

    @staticmethod
    def gap(got, want):
        label, = got
        return ChromEntry.gap(got[label], want[label])


ENTRY = Turns
'''

#: a new reference module: the banded reference of pyBHFDR, counting its
#: calls
REFERENCE = '''
from .banded import bhfdr as _bhfdr

CALLS = []


def bhfdr(*args, **kw):
    CALLS.append(1)
    return _bhfdr(*args, **kw)
'''


def test_a_cell_added_by_new_files_alone(tmp_path):
    """A new configuration naming a new reference module, a new traffic
    mix with a new entry module, and a new per-layer metric, each a new
    file, and new BENCHMARK.json entries: the harness runs the new cell
    through the new entry and reference and reports the new metric, and
    no file of the benchmark changes."""
    import sys
    before = digest_tree(PKG)
    root = make_root(tmp_path)
    pb = os.path.join(root, 'portbench')
    with open(os.path.join(pb, 'configs', 'bhfdr-k562-10kb.json')) as f:
        config = json.load(f)
    config['settings']['ww'] = 4
    config['reference'] = 'counted.bhfdr'
    with open(os.path.join(pb, 'configs', 'extra.json'), 'w') as f:
        json.dump(config, f)
    with open(os.path.join(pb, 'reference', 'counted.py'), 'w') as f:
        f.write(REFERENCE)
    with open(os.path.join(pb, 'mixes', 'turns.py'), 'w') as f:
        f.write(TURNS)
    with open(os.path.join(pb, 'traffic', 'chr2.json'), 'w') as f:
        json.dump({'entry': 'turns', 'chroms': ['2', '1'],
                   'trace_steps': 3}, f)
    with open(os.path.join(root, 'portbench', 'metrics',
                           'traced_calls.extra.py'), 'w') as f:
        f.write('def read(run):\n    return len(run.walls)\n')
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        spec = json.load(f)
    spec['configs'].append({'name': 'extra', 'source': 'x',
                            'file': 'portbench/configs/extra.json',
                            'reduced': [], 'why': 'x'})
    spec['workloads'].append({'name': 'extra.chr2', 'config': 'extra',
                              'traffic': 'chr2', 'chips': 1, 'why': 'x'})
    spec['end_to_end'][1]['workloads'].append('extra.chr2')
    spec['per_layer'].append({'name': 'traced_calls.extra', 'unit': 'calls',
                              'better': 'higher',
                              'source': 'program_counter', 'layer': 'x',
                              'moves': 'call_ms',
                              'workloads': ['extra.chr2']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(spec, f)
    res, _ = run(root, 'extra.chr2')
    assert res['correct'] and set(res['metrics']) == {'setup_s', 'call_ms'}
    calls = sys.modules['portbench.reference.counted'].CALLS
    assert len(calls) == 2
    res, _ = run(root, 'extra.chr2', trace=True)
    assert res['correct'] and res['attempted'] == 3
    assert res['distinct_answers'] == 2
    assert res['metrics']['traced_calls.extra'] == {'value': 3.0,
                                                    'unit': 'calls'}
    assert len(calls) == 4
    assert digest_tree(PKG) == before


def test_no_card_no_result(capsys):
    """Without a card the entry point exits 2 and prints no result."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    assert harness.main(['--workload', 'hiccups-k562-10kb.chr1', '--seed',
                         '1', '--seconds', '1']) == 2
    assert capsys.readouterr().out == ''


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails before its window and prints no result."""
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(PKG, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    code = ('import sys, time, torch\n'
            'from portbench import harness\n'
            'cell = harness.Cell(".", "hiccups-k562-10kb.chr1")\n'
            'harness.measure(cell, 1, 1.0, False, torch.device("cpu"), '
            'time.perf_counter())\n'
            'print("{}")\n')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert out.returncode != 0
    assert out.stdout == ''
    assert 'hicpeaks_tpu_torch' in out.stderr
