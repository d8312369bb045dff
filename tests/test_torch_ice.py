"""The port's ICE (hicpeaks_tpu_torch/ops/ice.py) against the JAX
package's on the CPU, and against test_ice.py's dense NumPy ICE.

The bar against JAX: the same NaN mask, the same ``converged`` flag and
``n_iters``, weights within rtol 1e-9.  JAX's scatter-adds and torch's
segment sums add in other orders, so bit equality is not on offer.  Against
the NumPy reference, test_ice.py's rtol (1e-6)."""
import numpy as np
import pytest
import torch

import jax
from hicpeaks_tpu.io import coolerlite as jcl
from hicpeaks_tpu.io.synth import synthesize_chrom
from hicpeaks_tpu.ops import ice as jice
from hicpeaks_tpu_torch.io import coolerlite as tcl
from hicpeaks_tpu_torch.ops import ice as tice
from .test_ice import _numpy_ice, _random_symmetric_counts

RTOL = 1e-9
CPU = jax.devices('cpu')[0]


def assert_ice_equal(got, want):
    assert np.array_equal(np.isnan(got.bias), np.isnan(want.bias))
    assert (got.converged, got.n_iters) == (want.converged, want.n_iters)
    np.testing.assert_allclose(got.bias, want.bias, rtol=RTOL)


def _band(S):
    n = S.shape[0]
    band = np.zeros((n, n))
    for d in range(n):
        idx = np.arange(n - d)
        band[d, idx] = S[idx, idx + d]
    return band


@pytest.mark.parametrize('gaps,max_iters', [((), 200), ((7, 8, 30), 200),
                                            ((), 3)])
def test_band_form_matches_jax_and_numpy(gaps, max_iters):
    n = 96
    S = _random_symmetric_counts(n, seed=4, gap_bins=gaps)
    band = _band(S)
    got = tice.ice_balance_chrom(band, n, max_iters=max_iters, device='cpu')
    assert_ice_equal(got, jice.ice_balance_chrom(band, n, max_iters=max_iters,
                                                 device=CPU))
    if max_iters == 200:
        np.testing.assert_allclose(got.bias, _numpy_ice(S), rtol=1e-6)
    else:
        assert not got.converged and got.n_iters == 3


@pytest.mark.parametrize('gaps,shuffled', [((), False), ((7, 8, 30), True)])
def test_coo_form_matches_jax_and_numpy(gaps, shuffled):
    """Pixels in any order: the port sorts them once per call."""
    n = 96
    S = _random_symmetric_counts(n, seed=5, gap_bins=gaps)
    x, y = np.triu_indices(n)
    keep = S[x, y] != 0
    x, y, v = x[keep], y[keep], S[x, y][keep]
    if shuffled:
        p = np.random.default_rng(0).permutation(x.size)
        x, y, v = x[p], y[p], v[p]
    got = tice.ice_balance_genome(x, y, v, n, device='cpu')
    assert_ice_equal(got, jice.ice_balance_genome(x, y, v, n, device=CPU))
    np.testing.assert_allclose(got.bias, _numpy_ice(S), rtol=1e-6)


def _two_chrom_cooler(module, path, trans):
    res, sizes, chunks, off = 25000, {}, [], 0
    rng = np.random.default_rng(9)
    for c, nb, seed in (('1', 160, 1), ('2', 120, 2)):
        b1, b2, ct, _, _ = synthesize_chrom(n_bins=nb, res=res, seed=seed,
                                            n_loops=8, depth=50.0)
        sizes[c] = nb * res
        chunks.append((b1 + off, b2 + off, ct))
        off += nb
    b1, b2, ct = (np.concatenate(a) for a in zip(*chunks))
    if trans:
        tx, ty = rng.integers(0, 160, 3000), rng.integers(160, 280, 3000)
        key = np.unique(tx * 280 + ty)
        b1 = np.r_[b1, key // 280]
        b2 = np.r_[b2, key % 280]
        ct = np.r_[ct, rng.integers(1, 4, key.size)]
        order = np.lexsort((b2, b1))
        b1, b2, ct = b1[order], b2[order], ct[order]
    uri = f'{path}::{res}'
    module.create_cooler_file(uri, jcl.binnify(sizes, res),
                              [{'bin1_id': b1, 'bin2_id': b2, 'count': ct}],
                              metadata={'onlyIntra': str(not trans)})
    return uri


@pytest.mark.parametrize('trans', [False, True])
def test_balance_matches_jax(tmp_path, trans):
    """balance() on the same pixels in both packages' coolers: the written
    column and its stats attributes (cis-only: a correction per
    chromosome, each with its own convergence)."""
    ju = _two_chrom_cooler(jcl, tmp_path / 'j.cool', trans)
    tu = _two_chrom_cooler(tcl, tmp_path / 't.cool', trans)
    want_stats = jice.balance(jcl.CoolerLite(ju))
    got_stats = tice.balance(tcl.CoolerLite(tu), device='cpu')
    assert got_stats == want_stats
    assert got_stats['cis_only'] is (not trans)
    want, got = jcl.CoolerLite(ju).weights(), tcl.CoolerLite(tu).weights()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    clr = tcl.CoolerLite(tu)
    if trans:
        parts = [(clr.pixels(), clr.nbins)]
    else:
        parts = [(clr.pixels_for_chrom(c), hi - lo) for c, (lo, hi) in
                 ((c, clr.bin_range(c)) for c in clr.chromnames)]
    for px, n in parts:
        assert_ice_equal(tice.ice_balance_genome(*px, n, device='cpu'),
                         jice.ice_balance_genome(*px, n, device=CPU))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the refusal path needs none')
    with pytest.raises(RuntimeError, match='CUDA'):
        tice.ice_balance_genome([0], [1], [1.0], 2)
    with pytest.raises(RuntimeError, match='CUDA'):
        tice.ice_balance_chrom(np.ones((2, 4)), 4)
