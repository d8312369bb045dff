"""The port's copies of the JAX package's host modules against the
originals, on the same seeded inputs: pool plans and freeze replays, the
band build (float32 through the port's own native library, float64
through numpy), the float64 ring sums and statistics, the clustering, the
cooler reader and the bedpe writers.  Every comparison is exact."""
import io

import numpy as np
import pytest

from hicpeaks_tpu.core import clustering as jclustering
from hicpeaks_tpu.core import poolplan as jpoolplan
from hicpeaks_tpu.io import peakfile as jpeakfile
from hicpeaks_tpu.io.coolerlite import CoolerLite as JCoolerLite
from hicpeaks_tpu.io.synth import synthesize_chrom, synthetic_cooler
from hicpeaks_tpu.ops import band as jband
from hicpeaks_tpu.ops import hostexact as jhostexact
from hicpeaks_tpu_torch.core import clustering as tclustering
from hicpeaks_tpu_torch.core import poolplan as tpoolplan
from hicpeaks_tpu_torch.io import peakfile as tpeakfile
from hicpeaks_tpu_torch.io import synth as tsynth
from hicpeaks_tpu_torch.io.coolerlite import CoolerLite as TCoolerLite
from hicpeaks_tpu_torch.ops import band as tband
from hicpeaks_tpu_torch.ops import hostexact as thostexact

PLANS = [((2,), (5,), 10), ((1, 2), (3, 5), 10), ((1, 2, 3), (3, 5, 6), 8),
         ((3, 1), (6, 4), 9), ((2,), (2,), 2)]


@pytest.mark.parametrize('pw,ww,maxww', PLANS)
def test_pool_plans_and_freeze_replays_equal(pw, ww, maxww):
    assert tpoolplan.pw_ww_pairs(pw, ww, maxww) == \
        jpoolplan.pw_ww_pairs(pw, ww, maxww)
    plan_t = tpoolplan.hiccups_pool_plan(pw, ww, maxww)
    plan_j = jpoolplan.hiccups_pool_plan(pw, ww, maxww)
    assert [tuple(vars(e).values()) for e in plan_t] == \
        [tuple(vars(e).values()) for e in plan_j]
    bplan_t = tpoolplan.bhfdr_pool_plan(pw[0], ww[0], maxww)
    bplan_j = jpoolplan.bhfdr_pool_plan(pw[0], ww[0], maxww)
    assert [tuple(vars(e).values()) for e in bplan_t] == \
        [tuple(vars(e).values()) for e in bplan_j]
    rng = np.random.default_rng(len(plan_t) * 7 + maxww)
    for total in (0, 1, 500, 12345):
        assert tpoolplan.left_threshold(total) == \
            jpoolplan.left_threshold(total)
        for _ in range(4):
            counts = rng.integers(0, max(total, 1) // 3 + 1, len(plan_t))
            assert vars(tpoolplan.emulate_freeze_hiccups(
                plan_t, counts, total, ww)) == vars(
                jpoolplan.emulate_freeze_hiccups(plan_j, counts, total, ww))
            bcounts = counts[:len(bplan_t)]
            assert vars(tpoolplan.emulate_freeze_bhfdr(
                bplan_t, bcounts, total)) == vars(
                jpoolplan.emulate_freeze_bhfdr(bplan_j, bcounts, total))


def _pixels(seed, L=700, span=60):
    b1, b2, ct, _, bias = synthesize_chrom(
        n_bins=L, res=10000, seed=seed, depth=30.0, n_loops=25,
        decay=0.8, max_loop_span_bins=span)
    w = np.full(L, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    return b1, b2, ct, w, L


_BAND_FIELDS = ('raw', 'IR', 'bias', 'w0', 'gap', 'nanw', 'cand_hist',
                'IR64', 'bias64', 'w064')


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('seed,num,ww_min', [(0, 51, 5), (1, 40, 3)])
def test_build_bands_bit_equal(dtype, seed, num, ww_min):
    """float32 runs the port's native library against the JAX package's;
    float64 runs both numpy paths."""
    b1, b2, ct, w, L = _pixels(seed)
    t = tband.build_bands(b1, b2, ct, w, L, num, ww_min, 10000, dtype=dtype)
    j = jband.build_bands(b1, b2, ct, w, L, num, ww_min, 10000, dtype=dtype)
    for f in _BAND_FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert t.max_count == j.max_count
    np.testing.assert_array_equal(t.cband, j.cband)
    assert t.candidate_total(ww_min, num - 1) == \
        j.candidate_total(ww_min, num - 1)


def test_build_bands_unsorted_pixels_take_numpy_path():
    """Pixels not sorted by bin1 are declined by the native routine; both
    packages then take the numpy path and agree."""
    b1, b2, ct, w, L = _pixels(2)
    perm = np.random.default_rng(2).permutation(b1.size)
    args = (b1[perm], b2[perm], ct[perm], w, L, 51, 5, 10000)
    t, j = tband.build_bands(*args), jband.build_bands(*args)
    for f in _BAND_FIELDS:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f)


def _exact_case(dtype, seed):
    b1, b2, ct, w, L = _pixels(seed)
    num = 51
    bands = tband.build_bands(b1, b2, ct, w, L, num, 5, 10000, dtype=dtype)
    plan = tuple(tpoolplan.hiccups_pool_plan((1, 2), (3, 5), 10))
    rng = np.random.default_rng(seed)
    d = rng.integers(5, num, 300)
    x = rng.integers(0, L - d)
    allowed = [True] * (len(plan) - 2) + [False, False]
    return bands, plan, allowed, d, x


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_exact_ring_sums_and_stats_bit_equal(dtype):
    """float32 bands take the native ring-sum walk in both packages,
    float64 bands the numpy gathers."""
    bands, plan, allowed, d, x = _exact_case(dtype, 3)
    ct = thostexact.ExactCtx(bands, plan, allowed, 16)
    cj = jhostexact.ExactCtx(bands, plan, allowed, 16)
    rt, rj = ct.ring_sums(d, x), cj.ring_sums(d, x)
    assert rt.keys() == rj.keys()
    for k in rt:
        np.testing.assert_array_equal(rt[k], rj[k], err_msg=k)
    for p in (1, 2):
        np.testing.assert_array_equal(thostexact.freeze_entries(ct, rt, p),
                                      jhostexact.freeze_entries(cj, rj, p))
        for kind in ('K', 'Y'):
            for a, b in zip(thostexact.exact_stats(ct, d, x, p, kind),
                            jhostexact.exact_stats(cj, d, x, p, kind)):
                np.testing.assert_array_equal(a, b)
    E = np.random.default_rng(4).gamma(2.0, 3.0, 500)
    for a, b in zip(thostexact.chunk_ids64(E, E > 1.0),
                    jhostexact.chunk_ids64(E, E > 1.0)):
        np.testing.assert_array_equal(a, b)


def _peak_tables(seed, n=400, res=10000):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 300, n) * res
    y = x + rng.integers(5, 60, n) * res
    donuts, ll = {}, {}
    for xi, yi in zip(x, y):
        donuts[(int(xi), int(yi))] = tuple(rng.random(5) * [50, 40, 4, 1e-3,
                                                            1e-2])
        ll[(int(xi), int(yi))] = tuple(rng.random(5) * [50, 40, 4, 1e-3,
                                                        1e-2])
    return donuts, ll


@pytest.mark.parametrize('seed,onlysummit,with_ll',
                         [(0, False, True), (1, True, True), (2, False, False)])
def test_local_clustering_equal_in_order(seed, onlysummit, with_ll):
    donuts, ll = _peak_tables(seed)
    if not with_ll:
        ll = None
        donuts = {k: v[1:] for k, v in donuts.items()}
    args = dict(res=10000, onlysummit=onlysummit, min_count=2, r=20000,
                sumq=0.01)
    got = tclustering.local_clustering(donuts, ll, **args)
    want = jclustering.local_clustering(donuts, ll, **args)
    assert len(want) > 0
    assert got == want


def test_cooler_reads_and_synthetic_cooler_equal(tmp_path):
    """The port's reader on a JAX-written cooler, and the port's writer's
    cooler read back by the JAX reader, give the same pixels and weights."""
    kw = dict(n_bins=300, res=10000, chrom='1', seed=5, depth=30.0,
              n_loops=10, max_loop_span_bins=40)
    uri_j, loops_j = synthetic_cooler(str(tmp_path / 'j.cool'), **kw)
    uri_t, loops_t = tsynth.synthetic_cooler(str(tmp_path / 't.cool'), **kw)
    assert loops_t == loops_j
    for uri in (uri_j, uri_t):
        t, j = TCoolerLite(uri), JCoolerLite(uri)
        assert (t.binsize, t.chromnames, t.nbins) == \
            (j.binsize, j.chromnames, j.nbins)
        for chrom in ('1', 'chr1'):
            assert t.bin_range(chrom) == j.bin_range(chrom)
            for a, b in zip(t.pixels_for_chrom(chrom),
                            j.pixels_for_chrom(chrom)):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(t.weights(chrom), j.weights(chrom))
    for a, b in zip(tsynth.synthesize_chrom(n_bins=200, seed=9),
                    synthesize_chrom(n_bins=200, seed=9)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize('writer,width', [('write_hiccups_bedpe', 10),
                                          ('write_bhfdr_bedpe', 7)])
def test_bedpe_writers_write_same_bytes(writer, width):
    rng = np.random.default_rng(width)
    table = {}
    for _ in range(50):
        x = int(rng.integers(0, 500)) * 10000
        y = x + int(rng.integers(1, 200)) * 10000
        vals = rng.random(width - 3) * 10.0 ** rng.integers(-20, 3,
                                                            width - 3)
        table[(x, y)] = (x, y, 20000) + tuple(float(v) for v in vals)
    outs = []
    for mod in (tpeakfile, jpeakfile):
        buf = io.StringIO()
        getattr(mod, writer)(buf, 'chr7', 10000, table)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0].count('\n') == 50
