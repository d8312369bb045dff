"""The port's pyHICCUPS engine (hicpeaks_tpu_torch/core/engine.py, on the
CPU through the kernels' plain twins) against the JAX engine and the
float64 oracle, on the synthetic cooler of test_engine_parity.py."""
import numpy as np
import pytest
import torch

from hicpeaks_tpu.core import engine as jengine
from hicpeaks_tpu.core.config import HiccupsConfig
from hicpeaks_tpu.io.coolerlite import CoolerLite
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.core import engine as tengine

from .oracle import reference_impl as oracle
from .oracle.prep import prepare_chrom
from .torch_threads import one_intra_op_thread  # noqa: F401

CONFIGS = [((1,), (3,), 8), ((1, 2), (3, 5), 8)]


@pytest.fixture(scope='module')
def clr(tmp_path_factory):
    path = tmp_path_factory.mktemp('data') / 'parity.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=420, res=25000, seed=11,
                              n_loops=30, depth=60.0)
    return CoolerLite(uri)


@pytest.fixture(scope='module')
def oracle_tables(clr):
    out = {}
    for pw, ww, maxww in CONFIGS:
        d = prepare_chrom(clr, '21', 2000000, maxww, min(ww))
        out[(pw, ww, maxww)] = oracle.hiccups(
            d['Md'], d['cMd'], d['B'], d['B'], d['IR'], d['chromLen'],
            d['num'], pw=list(pw), ww=list(ww), maxww=maxww, sig=0.05,
            sumq=0.01, double_fold=1.75, single_fold=2.0, maxapart=2000000,
            res=clr.binsize, min_marginal_peaks=2, onlyanchor=False,
            min_local_reads=16)
    return out


def _assert_tables_match(got, want, rtol):
    """Identical loci and geometry; the statistics (O, FoldK, pK, qK,
    FoldY, pY, qY) within ``rtol``, a number or one per statistic."""
    assert set(got) == set(want), (
        f'locus sets differ: extra={sorted(set(got) - set(want))[:5]} '
        f'missing={sorted(set(want) - set(got))[:5]}')
    for key in want:
        g, w = got[key], want[key]
        assert tuple(g[:3]) == tuple(w[:3]), f'{key}: geometry'
        g, w = np.asarray(g[3:], float), np.asarray(w[3:], float)
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
        assert (rel <= np.asarray(rtol, float)).all(), (
            f'{key}: got {g.tolist()}, want {w.tolist()}, relative '
            f'difference {rel.tolist()} above {rtol}')


#: Segmented BH emits the device's float32 p and q (JAX's right edge is
#: weakly typed, so p takes O's float32 in either band dtype).  torch's and
#: XLA's float32 igamma differ by up to 3.7e-4 relative over counts
#: 0-400 at the chunk edges, so p and q hold at 1e-3 and the rest at
#: 1e-12.
SEGMENTED_RTOL = (1e-12, 1e-12, 1e-3, 1e-3, 1e-12, 1e-3, 1e-3)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('pw,ww,maxww', CONFIGS)
def test_hiccups_chrom_matches_jax_and_oracle(clr, oracle_tables, pw, ww,
                                              maxww, dtype):
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, siglevel=0.05, sumq=0.01,
                        maxapart=2000000, min_marginal_peaks=2,
                        min_local_reads=16, only_anchors=False)

    def bands():
        return bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww,
                                 min(ww), dtype=dtype)

    want = jengine.hiccups_chrom(bands(), cfg)
    got = tengine.hiccups_chrom(bands(), cfg, device='cpu')
    assert len(want) > 0
    _assert_tables_match(got, want, rtol=1e-12)
    _assert_tables_match(got, oracle_tables[(pw, ww, maxww)], rtol=1e-8)


@pytest.mark.parametrize('only_anchors', [False, True])
def test_quickstart_three_pairs_match_jax(clr, only_anchors):
    """The upstream QuickStart's pyHICCUPS (README.rst:198-203: pw 1 2 4,
    ww 3 5 7, only anchors) and the same pairs with the gate off: six
    backgrounds, the cross-pair merge and the anchor gate, held to the JAX
    engine as the cases above are, in the benchmark's float32 bands."""
    cfg = HiccupsConfig(pw=(1, 2, 4), ww=(3, 5, 7), maxww=10, siglevel=0.05,
                        sumq=0.01, maxapart=2000000, min_marginal_peaks=2,
                        min_local_reads=16, only_anchors=only_anchors)

    def bands():
        return bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                                 dtype=np.float32)

    want = jengine.hiccups_chrom(bands(), cfg)
    got = tengine.hiccups_chrom(bands(), cfg, device='cpu')
    assert len(want) > 0
    assert list(got) == list(want)
    _assert_tables_match(got, want, rtol=1e-12)


@pytest.fixture(scope='module')
def deep_clr(tmp_path_factory):
    """The same synthesis at a depth whose largest count plans the
    histogram cap 4096 (S = 48 chunk rows), as deeper Hi-C does."""
    path = tmp_path_factory.mktemp('data') / 'deep.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=420, res=25000, seed=11,
                              n_loops=30, depth=250.0)
    return CoolerLite(uri)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('pw,ww,maxww', CONFIGS)
def test_hiccups_chrom_deep_data_matches_jax(deep_clr, pw, ww, maxww,
                                             dtype):
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, siglevel=0.05, sumq=0.01,
                        maxapart=2000000, min_marginal_peaks=2,
                        min_local_reads=16, only_anchors=False)

    def bands():
        return bands_from_cooler(deep_clr, '21', cfg.maxapart, cfg.maxww,
                                 min(ww), dtype=dtype)

    assert tengine._bh_plan(bands().max_count) == 4096
    want = jengine.hiccups_chrom(bands(), cfg)
    got = tengine.hiccups_chrom(bands(), cfg, device='cpu')
    assert len(want) > 0
    assert list(got) == list(want)
    _assert_tables_match(got, want, rtol=1e-12)


def test_mesh_checkify_and_cap_overflow_served(clr):
    """A mesh that is not a TileMesh raises TypeError and a 4-tile CPU
    mesh returns the single-device table; checkify and a max count above
    the histogram cap return the JAX engine's table."""
    from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh
    cfg = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=2000000)

    def bands():
        return bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                                 dtype=np.float64)

    with pytest.raises(TypeError, match='TileMesh'):
        tengine.hiccups_chrom(bands(), cfg, device='cpu', mesh=object())
    single = tengine.hiccups_chrom(bands(), cfg, device='cpu')
    assert len(single) > 0
    _assert_tables_match(
        tengine.hiccups_chrom(bands(), cfg, mesh=make_tile_mesh(
            devices=['cpu'] * 4)), single, rtol=1e-12)
    want = jengine.hiccups_chrom(bands(), cfg, check=True)
    assert len(want) > 0
    _assert_tables_match(
        tengine.hiccups_chrom(bands(), cfg, device='cpu', check=True), want,
        rtol=1e-12)
    deep = [bands() for _ in range(2)]
    for b in deep:
        b.max_count = float((1 << 17) + 1)
    want = jengine.hiccups_chrom(deep[0], cfg)
    assert len(want) > 0
    _assert_tables_match(tengine.hiccups_chrom(deep[1], cfg, device='cpu'),
                         want, rtol=SEGMENTED_RTOL)


def test_bands_to_device_keeps_dtypes(clr):
    b = bands_from_cooler(clr, '21', 2000000, 8, 3, dtype=np.float64)
    ops = tengine.bands_to_device(b, 'cpu')
    for k in ('raw', 'w0', 'bias', 'IR', 'gap'):
        a = getattr(b, k)
        assert ops[k].dtype == torch.from_numpy(np.asarray(a)).dtype, k
        np.testing.assert_array_equal(ops[k].numpy(), a)
