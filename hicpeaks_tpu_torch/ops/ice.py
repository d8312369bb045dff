"""ICE matrix balancing (iterative correction) in PyTorch, float64, on the
device given.

Port of ``hicpeaks_tpu/ops/ice.py``: the band form (``ice_balance_chrom``),
the COO form (``ice_balance_genome``) and ``balance``, the reference's
``balance()`` wrapper around ``cooler.ice.iterative_correction``
(utilities.py:367-431).  JAX's ``jax.jit`` programs have no Pallas kernel;
here they are plain torch ops.

Knobs and semantics follow the reference call site: chunk-free, mad_max=5,
min_nnz=10, min_count=0, ignore_diags=1, tol=1e-5, max_iters=200, with
``rescale_marginals`` (bias /= sqrt(mean nonzero marginal)) and NaN at
filtered-out bins.  Convergence is tested on the scale-free variance of the
nonzero marginals (variance of marginals divided by their mean).

Every sum is free of atomics, so two runs on the card give the same
weights bit for bit: the band form sums along the diagonal axis of its
slab, and the COO form's marginals are segment sums, each bin's pixels
added in order (``torch.segment_reduce``): the row part over the pixels
sorted by bin1, the column part over a stable bin2 permutation computed
once.  JAX scatters instead, so the two agree to rounding, not to the bit.

Left out: JAX's power-of-two COO padding (it shared XLA programs) and its
thread pool over chromosomes; the bin1 index is read through CoolerLite,
not h5py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.engine import resolve_device


@dataclass
class IceResult:
    bias: np.ndarray
    var: float
    converged: bool
    n_iters: int
    scale: float


def _nanmedian(x):
    """numpy's nanmedian (the mean of the two middle values for an even
    count); NaN when every value is NaN."""
    v = torch.sort(x[~torch.isnan(x)]).values
    n = v.numel()
    if n == 0:
        return torch.tensor(float('nan'), dtype=x.dtype, device=x.device)
    if n % 2:
        return v[n // 2]
    return v[n // 2 - 1] * 0.5 + v[n // 2] * 0.5


def _iterate(marginal, nnz, mask, min_nnz, min_count, mad_max, tol,
             max_iters):
    """The filters and the correction loop shared by both forms: ``mask``
    holds the bins that exist, ``marginal(b)`` is the symmetric matvec's
    row sums.  -> (b, mask, var, n_iters, scale)."""
    marg0 = marginal(torch.ones_like(nnz))
    if min_nnz > 0:
        mask = mask & (nnz >= min_nnz)
    if min_count > 0:
        mask = mask & (marg0 >= min_count)
    if mad_max > 0:
        m = torch.where(mask, marg0, 0.0)
        pos = m > 0
        logm = torch.where(pos, torch.log(torch.where(pos, m, 1.0)),
                           float('nan'))
        med = _nanmedian(logm)
        dev = _nanmedian(torch.abs(logm - med))
        mask = mask & (m >= torch.exp(med - mad_max * dev))
    b = mask.to(nnz.dtype)

    def mean_nz(m):
        nzm = m > 0
        cnt = torch.clamp(nzm.sum(), min=1)
        return nzm, cnt, torch.where(nzm, m, 0.0).sum() / cnt

    var, it = float('inf'), 0
    while var >= tol and it < max_iters:
        m = marginal(b)
        nzm, cnt, mean = mean_nz(m)
        b = b / torch.where(nzm, m / mean, 1.0)
        var = float(torch.where(nzm, (m / mean - 1.0) ** 2, 0.0).sum() / cnt)
        it += 1
    _, _, scale = mean_nz(marginal(b))
    b = b / torch.sqrt(torch.where(scale > 0, scale, 1.0))
    return b, mask, var, it, float(scale)


def _result(b, mask, var, it, scale, tol, n):
    b = b.cpu().numpy()[:n]
    mask = mask.cpu().numpy()[:n]
    return IceResult(bias=np.where(mask & (b > 0), b, np.nan), var=var,
                     converged=var < tol, n_iters=it, scale=scale)


def ice_balance_chrom(raw_band, L, ignore_diags=1, mad_max=5, min_nnz=10,
                      min_count=0, tol=1e-5, max_iters=200,
                      device='cuda') -> IceResult:
    """Balance one chromosome band (``raw_band[d, x]`` = pixel (x, x + d));
    returns cooler-convention weights (NaN at filtered bins) of length L.
    JAX's sliding rows and shear are gathers here: ``b[x + d]`` and
    ``scaled[d, y - d]``."""
    dev = resolve_device(device)
    band = torch.as_tensor(np.asarray(raw_band, np.float64), device=dev)
    num_p, Lp = band.shape
    d = torch.arange(num_p, device=dev)[:, None]
    x = torch.arange(Lp, device=dev)[None, :]
    band = torch.where((d >= ignore_diags) & (x < L - d), band, 0.0)
    up = torch.clamp(x + d, max=Lp - 1)                 # column y = x + d
    src = torch.clamp(x - d, min=0)                     # row x = y - d
    below = (x - d >= 0) & (d > 0)                      # d = 0 is a row term

    def by_column(a):
        return torch.where(below, torch.gather(a, 1, src), 0.0).sum(0)

    def marginal(b):
        by = torch.where(x + d < Lp, b[up], 0.0)
        scaled = band * b[None, :] * by
        return scaled.sum(0) + by_column(scaled)

    nz = (band != 0).to(band.dtype)
    nnz = nz.sum(0) + by_column(nz)
    b, mask, var, it, scale = _iterate(
        marginal, nnz, torch.arange(Lp, device=dev) < L, min_nnz, min_count,
        mad_max, tol, max_iters)
    return _result(b, mask, var, it, scale, tol, L)


def ice_balance_genome(bin1, bin2, count, n_bins, ignore_diags=1, mad_max=5,
                       min_nnz=10, min_count=0, tol=1e-5, max_iters=200,
                       device='cuda') -> IceResult:
    """Balancing over a COO pixel list (upper triangle, genome-wide ids):
    the reference's ``cis_only=False`` branch (utilities.py:398-417), and
    one chromosome of the cis-only one.  Each stored pixel adds to its row
    and column bin (the diagonal once); ``ignore_diags`` masks by id
    distance.  Returns weights of length ``n_bins``."""
    dev = resolve_device(device)
    b1 = torch.as_tensor(np.asarray(bin1, np.int64), device=dev)
    b2 = torch.as_tensor(np.asarray(bin2, np.int64), device=dev)
    ct = torch.as_tensor(np.asarray(count, np.float64), device=dev)
    ct = torch.where(b2 - b1 < ignore_diags, 0.0, ct)
    offdiag = b1 != b2
    rows = torch.sort(b1, stable=True).indices
    cols = torch.sort(b2, stable=True).indices
    row_len = torch.bincount(b1, minlength=n_bins)
    col_len = torch.bincount(b2, minlength=n_bins)
    b1r, b2r, ctr = b1[rows], b2[rows], ct[rows]
    b1c, b2c = b1[cols], b2[cols]
    ctc = torch.where(offdiag, ct, 0.0)[cols]

    def segsum(v, lengths):
        return torch.segment_reduce(v, 'sum', lengths=lengths, unsafe=True)

    def marginal(b):
        return segsum(ctr * b[b1r] * b[b2r], row_len) + \
            segsum(ctc * b[b1c] * b[b2c], col_len)

    nz = (ct != 0).to(ct.dtype)
    nnz = segsum(nz[rows], row_len) + \
        segsum(torch.where(offdiag, nz, 0.0)[cols], col_len)
    b, mask, var, it, scale = _iterate(
        marginal, nnz, torch.ones(n_bins, dtype=torch.bool, device=dev),
        min_nnz, min_count, mad_max, tol, max_iters)
    return _result(b, mask, var, it, scale, tol, n_bins)


def balance(clr, nproc=1, chunksize=int(1e7), mad_max=5, min_nnz=10,
            min_count=0, ignore_diags=1, tol=1e-5, max_iters=200,
            weight_name='weight', cis_only=None, device='cuda'):
    """Balance a cooler group on ``device`` and persist bins/weight,
    mirroring the reference ``balance()`` entry point (utilities.py:
    367-431).  ``cis_only`` defaults to the cooler's ``onlyIntra``
    metadata (utilities.py:398-402): intra-only files get independent
    per-chromosome correction (each chromosome its own mean and its own
    convergence), trans-inclusive files one genome-wide correction.
    ``nproc``/``chunksize`` are accepted for CLI compatibility.  Returns
    the stats written as the column's attributes."""
    if cis_only is None:
        meta = clr.info.get('metadata') or {}
        cis_only = str(meta.get('onlyIntra', 'True')) == 'True'
    stats = {'tol': tol, 'min_nnz': min_nnz, 'min_count': min_count,
             'mad_max': mad_max, 'cis_only': bool(cis_only),
             'ignore_diags': ignore_diags, 'converged': True}
    knobs = dict(ignore_diags=ignore_diags, mad_max=mad_max,
                 min_nnz=min_nnz, min_count=min_count, tol=tol,
                 max_iters=max_iters, device=device)
    if not cis_only:
        result = ice_balance_genome(*clr.pixels(), clr.nbins, **knobs)
        stats['converged'] = result.converged
        clr.write_weights(result.bias, stats, name=weight_name)
        return stats
    weights = []
    for chrom in clr.chromnames:
        lo, hi = clr.bin_range(chrom)
        result = ice_balance_genome(*clr.pixels_for_chrom(chrom), hi - lo,
                                    **knobs)
        stats['converged'] = bool(stats['converged'] and result.converged)
        weights.append(result.bias)
    clr.write_weights(np.concatenate(weights) if weights
                      else np.zeros(0), stats, name=weight_name)
    return stats
