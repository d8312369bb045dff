"""The configuration ``hiccups-k562-10kb-3pairs`` (the upstream
QuickStart's pyHICCUPS: pw 1 2 4, ww 3 5 7, only anchors): the banded
reference against its frozen dense oracle at those settings, the cell
run whole on the CPU at a tiny size (sound, and with its answer broken),
the check's limit between the program and its controls, and the readers
of the merge's and the clustering's spans (pair_merge_ms.call,
anchors_ms.call) on hand-written traces."""
import time

import pytest
import torch

from portbench import control, harness
from portbench.reference import banded, dense
from portbench.tests.test_portbench_reference import RES, pixels, same
from portbench.tests.test_portbench_runs import alter_one, broken, drop_one
from portbench.tests.test_portbench_stages import STAGES
from portbench.tests.test_portbench_trace import EVENTS, ev, read, run_of
from portbench.tests.tiny import make_root
from portbench.trace import Trace

CELL = 'hiccups-k562-10kb-3pairs.chr1'
CPU = torch.device('cpu')
QUICKSTART = dict(pw=(1, 2, 4), ww=(3, 5, 7), maxww=10, siglevel=0.05,
                  sumq=0.01, double_fold=1.75, single_fold=2.0,
                  use_raw=False, min_marginal_peaks=2, min_local_reads=16,
                  only_anchors=True)
NEW = ('pair_merge_ms.call', 'anchors_ms.call')


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp('root'))


@pytest.mark.parametrize('L,seed,maxapart', [(420, 3, 1_500_000),
                                             (500, 2**40 + 4, 2_000_000)])
def test_banded_equals_dense_oracle_at_three_pairs(L, seed, maxapart):
    num = maxapart // RES + QUICKSTART['maxww'] + 1
    b1, b2, ct, w = pixels(L, seed, num)
    cfg = dict(QUICKSTART, maxapart=maxapart)
    D = dense.dense_inputs(b1, b2, ct, w, L, num, min(cfg['ww']))
    want = dense.hiccups(
        D['Md'], D['cMd'], D['B'], D['B'], D['IR'], L, num,
        pw=list(cfg['pw']), ww=list(cfg['ww']), maxww=cfg['maxww'],
        sig=0.05, sumq=0.01, maxapart=maxapart, res=RES,
        min_marginal_peaks=2, onlyanchor=True, min_local_reads=16)
    assert len(want) > 0
    same(banded.hiccups((b1, b2, ct, w, L, RES), cfg, 'cpu'), want)


def test_cell_sound_and_broken(root):
    """The cell runs through the harness on the CPU, correct, with the
    end-to-end metrics it lists; an answer altered or a locus dropped
    where it is produced makes it incorrect."""
    cell = harness.Cell(root, CELL)
    assert cell.config['settings']['pw'] == [1, 2, 4]
    assert cell.config['settings']['only_anchors'] is True
    res, _ = harness.measure(cell, 2**40 + 11, 0.2, False, CPU,
                             time.perf_counter())
    assert res['correct'] and res['attempted'] > 0
    assert set(res['metrics']) == {'setup_s', 'call_ms'}
    for change in (alter_one, drop_one):
        res, _ = harness.measure(cell, 2**40 + 11, 0.2, False, CPU,
                                 time.perf_counter(),
                                 patch=lambda e: broken(e, change))
        assert not res['correct'], change.__name__


def test_traced_run_reads_the_new_spans(root):
    """A traced run of the cell on the CPU reads both new metrics."""
    cell = harness.Cell(root, CELL)
    res, _ = harness.measure(cell, 12, 0.2, True, CPU, time.perf_counter())
    assert res['correct']
    for name in NEW:
        assert res['metrics'][name]['value'] > 0, name


def test_program_within_limit_and_controls_beyond(root):
    """The program's CPU path within the configuration's limit of the
    reference; its dense route and the reference in float32 beyond it."""
    cell = harness.Cell(root, CELL)
    limit = cell.config['gap_limit']
    r = control.readings(cell, 2**40 + 13, CPU)
    assert r['peaks'] > 0
    assert r['program'] <= limit < r['program_dense'], r
    assert r['reference_f32'] > limit, r


# the merge and the clustering of EVENTS' two calls: three pair merges
# 81-82, 82-83, 83-84 and 181-182, 182-184, 184-185 (one call's three
# pairs each), the anchor stage 85-86 and 186-187
PAIRS = STAGES + [
    ev('user_annotation', 'hicpeaks.pair_merge', 81, 1),
    ev('user_annotation', 'hicpeaks.pair_merge', 82, 1),
    ev('user_annotation', 'hicpeaks.pair_merge', 83, 1),
    ev('user_annotation', 'hicpeaks.pair_merge', 181, 1),
    ev('user_annotation', 'hicpeaks.pair_merge', 182, 2),
    ev('user_annotation', 'hicpeaks.pair_merge', 184, 1),
    ev('user_annotation', 'hicpeaks.anchors', 85, 1),
    ev('user_annotation', 'hicpeaks.anchors', 186, 1),
]


def test_pair_merge_and_anchors_readers():
    run = run_of(Trace(PAIRS))
    assert read('pair_merge_ms.call', run) == pytest.approx(
        (1 + 1 + 1 + 1 + 2 + 1) / 1e3 / 2)
    assert read('anchors_ms.call', run) == pytest.approx((1 + 1) / 1e3 / 2)


@pytest.mark.parametrize('events', [None, EVENTS, STAGES],
                         ids=['untraced', 'no-stage-marks', 'parents-marks'])
def test_readers_without_the_spans_return_none(events):
    """No trace, a trace without the program's marks, and the trace of a
    program whose marks lack these two spans read nothing."""
    run = run_of(None if events is None else Trace(events))
    for name in NEW:
        assert read(name, run) is None, name

