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
    assert set(got) == set(want), (
        f'locus sets differ: extra={sorted(set(got) - set(want))[:5]} '
        f'missing={sorted(set(want) - set(got))[:5]}')
    for key in want:
        g, w = got[key], want[key]
        assert tuple(g[:3]) == tuple(w[:3]), f'{key}: geometry'
        np.testing.assert_allclose(np.asarray(g[3:], float),
                                   np.asarray(w[3:], float), rtol=rtol,
                                   atol=1e-300, err_msg=str(key))


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


def test_unported_fallbacks_raise(clr):
    """Every case that would take the non-fused fallback ladder raises and
    names the roadmap item; none quietly computes something else."""
    cfg = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=2000000)
    b = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3)
    for kw in (dict(mesh=object()), dict(check=True)):
        with pytest.raises(NotImplementedError, match='item 10'):
            tengine.hiccups_chrom(b, cfg, device='cpu', **kw)
    b.max_count = float((1 << 17) + 1)
    with pytest.raises(NotImplementedError, match='item 10'):
        tengine.hiccups_chrom(b, cfg, device='cpu')


def test_bands_to_device_keeps_dtypes(clr):
    b = bands_from_cooler(clr, '21', 2000000, 8, 3, dtype=np.float64)
    ops = tengine.bands_to_device(b, 'cpu')
    for k in ('raw', 'w0', 'bias', 'IR', 'gap'):
        a = getattr(b, k)
        assert ops[k].dtype == torch.from_numpy(np.asarray(a)).dtype, k
        np.testing.assert_array_equal(ops[k].numpy(), a)
