"""pyHICCUPS with the upstream QuickStart's settings (README.rst:198-203:
``--pw 1 2 4 --ww 3 5 7 --only-anchors``, maxww 10) against the
benchmark's plain reference (``portbench/reference/banded.hiccups``,
float64 numpy and scipy), on seeded synthetic chromosomes at a small
size: the three pairs' union of pool steps, the six backgrounds, the
cross-pair merge with its best-q replacement and the only-anchors gate
on the clustering's singletons.  A table is held to the reference by
``portbench/compare.table_gap`` and the configuration's ``gap_limit``,
as the benchmark holds the cell ``hiccups-k562-10kb-3pairs.chr1``.

Only the port and the benchmark's reference are imported (no JAX): on
the CPU the kernels' wrappers run their plain twins."""
import json
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from hicpeaks_tpu_torch.core import engine
from hicpeaks_tpu_torch.core.config import HiccupsConfig
from hicpeaks_tpu_torch.ops.band import build_bands
from portbench import compare
from portbench.gen import synth
from portbench.reference import banded

from .torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 10000
L, MAXAPART = 400, 1_500_000
QUICKSTART = dict(pw=(1, 2, 4), ww=(3, 5, 7), maxww=10, siglevel=0.05,
                  sumq=0.01, double_fold=1.75, single_fold=2.0,
                  maxapart=MAXAPART, use_raw=False, min_marginal_peaks=2,
                  min_local_reads=16)
NUM = MAXAPART // RES + QUICKSTART['maxww'] + 1


def _gap_limit():
    path = os.path.join(REPO, 'portbench', 'configs',
                        'hiccups-k562-10kb-3pairs.json')
    with open(path) as f:
        return json.load(f)['gap_limit']


GAP_LIMIT = _gap_limit()


def _pixels(seed):
    """One chromosome's (bin1, bin2, count, weights) as the benchmark draws
    them, with the flatter band its CPU tests use at a few hundred bins."""
    syn = dict(depth=40.0, decay=0.75, bins_per_loop=12,
               max_loop_span_bins=NUM - 64)
    return synth.chrom_pixels(syn, L, RES, seed, 0)[:4]


#: (seed, only_anchors, dtype) -> (the port's table, the reference's, the
#: arguments of the port's cross-pair merge), shared by the tests below
_TABLES = {}


def _tables(seed, only_anchors, dtype=np.float32):
    """(the port's table, the reference's, the merge's arguments) of one
    seed, computed once a module."""
    key = (seed, only_anchors, np.dtype(dtype).name)
    if key not in _TABLES:
        cfg = dict(QUICKSTART, only_anchors=only_anchors)
        b1, b2, ct, w = _pixels(seed)
        bands = build_bands(b1, b2, ct, w, L, NUM, min(cfg['ww']), RES,
                            chrom='1', dtype=dtype)
        seen = {}
        real = engine._merge_pairs

        def spy(results, pairs, c, res):
            seen['args'] = (results, pairs, c, res)
            return real(results, pairs, c, res)
        engine._merge_pairs = spy
        try:
            got = engine.hiccups_chrom(bands, HiccupsConfig(**cfg),
                                       device='cpu')
        finally:
            engine._merge_pairs = real
        want = banded.hiccups((b1, b2, ct, w, L, RES), cfg, 'cpu')
        _TABLES[key] = got, want, seen['args']
    return _TABLES[key]


@pytest.mark.parametrize('seed', [1, 2**40 + 7])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('only_anchors', [False, True])
def test_three_pairs_within_the_limit_of_the_reference(seed, dtype,
                                                       only_anchors):
    got, want, _ = _tables(seed, only_anchors, dtype)
    assert len(want) > 0
    gap, where = compare.table_gap(got, want)
    assert gap <= GAP_LIMIT, (gap, where)


def test_only_anchors_drops_singletons_as_the_reference_does():
    """The gate takes singletons (radius 0) off the table, and only them;
    the reference takes off the same loci."""
    off, want_off, _ = _tables(1, False)
    on, want_on, _ = _tables(1, True)
    dropped = set(off) - set(on)
    assert dropped and set(on) <= set(off)
    assert all(off[k][2] == 0 for k in dropped)
    assert dropped == set(want_off) - set(want_on)


def test_a_later_pair_replaces_an_earlier_pairs_entry():
    """Some pixel kept by an earlier pair is replaced by a later pair's
    row, with lower q-values in both backgrounds; the table is the
    reference's all the same."""
    got, want, (results, pairs, cfg, res) = _tables(1, True)
    assert compare.table_gap(got, want)[0] <= GAP_LIMIT
    assert len(pairs) == 3
    replaced = 0
    for k in range(1, len(pairs)):
        before = engine._merge_pairs(results[:k], pairs[:k], cfg, res)
        after = engine._merge_pairs(results[:k + 1], pairs[:k + 1], cfg,
                                    res)
        for key, row in before.items():
            if after[key] != row:
                assert after[key][7] < row[7] and after[key][10] < row[10]
                replaced += 1
    assert replaced > 0


def _marks(prof, tmp_path):
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [e for e in events if e.get('ph') == 'X'
            and e.get('cat') == 'user_annotation'
            and e['name'].startswith('hicpeaks.')]


def _inside(e, outer):
    return any(o['ts'] <= e['ts'] and e['ts'] + e['dur'] <= o['ts'] + o['dur']
               for o in outer)


@pytest.mark.parametrize('pw,ww', [((2,), (5,)), ((1, 2, 4), (3, 5, 7))])
def test_pair_merge_once_a_pair_and_anchors_twice_a_call(pw, ww, tmp_path):
    """On a traced call ``hicpeaks.pair_merge`` fires once a (pw, ww) pair,
    inside ``hicpeaks.merge``, and ``hicpeaks.anchors`` twice (the anchors,
    then the singleton pass), inside ``hicpeaks.clustering``; the table is
    the untraced call's."""
    cfg = HiccupsConfig(**dict(QUICKSTART, pw=pw, ww=ww, only_anchors=True))
    b1, b2, ct, w = _pixels(2)

    def call():
        bands = build_bands(b1, b2, ct, w, L, NUM, min(ww), RES, chrom='1',
                            dtype=np.float32)
        return engine.hiccups_chrom(bands, cfg, device='cpu')
    want = call()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = call()
    assert len(want) > 0
    assert got == want and list(got) == list(want)
    marks = _marks(prof, tmp_path)
    by = {n: [e for e in marks if e['name'] == n]
          for n in ('hicpeaks.merge', 'hicpeaks.pair_merge',
                    'hicpeaks.clustering', 'hicpeaks.anchors')}
    assert len(by['hicpeaks.pair_merge']) == len(pw)
    assert len(by['hicpeaks.anchors']) == 2
    assert all(_inside(e, by['hicpeaks.merge'])
               for e in by['hicpeaks.pair_merge'])
    assert all(_inside(e, by['hicpeaks.clustering'])
               for e in by['hicpeaks.anchors'])
