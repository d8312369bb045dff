"""Diagonal-band tensor construction.

The port's copy of ``hicpeaks_tpu/ops/band.py``: float32 bands go through
the port's native host library (:mod:`.bandnative`), which is built at
first use and raises if it cannot be; other dtypes and pixels not sorted
by bin1 take the numpy path.

The TPU engine's core data structure replaces the reference's per-diagonal
scipy sparse matrices (scripts/pyHICCUPS:146-159) with dense band tensors
``band[d, x] = M[x, x + d]`` of shape [num_diags, L]:

* ``raw``   — raw counts, diagonals 0..num-1            (reference ``M``)
* ``cband`` — ICE-balanced counts, diagonals ww..num-1, NaN zeroed
              (reference ``cM``); *lazy* — the production engine never
              materializes it on the host, it is rebuilt on device as
              ``raw * w0[x] * w0[y]`` (ops/score.build_sheets_device)
* ``IR``    — per-diagonal NaN-aware mean of the balanced matrix, the
              distance-decay expected (scripts/pyHICCUPS:150-158)
* ``bias``  — 1/weight with invalid bins zeroed (scripts/pyHICCUPS:163-166)
* ``w0``    — weights with invalid bins zeroed (the device cband factor)
* ``gap``   — per-bin gap flag: balanced band column-sum == 0
              (reference gap bins, callers.py:238)

The NaN-mean semantics mirror the sparse fetch exactly: an entry is "NaN"
only where a *nonzero raw pixel* meets an invalid weight; structural zeros
count toward the mean's denominator.

Only ``raw`` is a dense host array; everything else the engine needs is a
vector, so the host→device transfer per chromosome is one slab + O(L)
vectors (the round-1 path shipped five dense slabs).
"""
from __future__ import annotations

import numpy as np


def _round_up(x, m):
    return (x + m - 1) // m * m


class ChromBands:
    """Host-side per-chromosome bundle.

    ``cband`` is a lazy property: tests, the float64 oracle, and the
    benchmark's explicit-transfer mode still read the dense balanced band,
    but the production engine path never touches it (it derives the same
    values on device from ``raw`` and ``w0``).
    """

    def __init__(self, raw, IR, bias, w0, gap, L, num, res, chrom='',
                 ww_min=0, sparse=None, cband=None, nanw=None,
                 cand_hist=None, max_count=None, IR64=None, bias64=None,
                 w064=None):
        self.IR64 = IR64        # [num_p] f64 pre-cast IR (host-exact
                                # float64 statistics, ops/hostexact.py)
        self.bias64 = bias64    # [Lp] f64 pre-cast 1/weight
        self.w064 = w064        # [Lp] f64 pre-cast weight (invalid->0)
        self.max_count = max_count  # max raw count (engine o_cap planning;
                                    # None -> engine reads raw.max())
        self.cand_hist = cand_hist  # [num_p] GLOBAL nonzero-pixel counts
                                    # per diagonal (multi-host sharded
                                    # ingestion reduces it across hosts;
                                    # None -> derive from local _sparse)
        self.raw = raw          # [num_p, Lp] dtype
        self.IR = IR            # [num_p]
        self.bias = bias        # [Lp]
        self.w0 = w0            # [Lp]
        self.gap = gap          # [Lp] bool
        self.nanw = nanw        # [Lp] bool — NaN weights (zero weights are
                                # *not* NaN: they contribute 0 to diagonal
                                # sums but stay in the mean's denominator)
        self.L = L
        self.num = num
        self.res = res
        self.chrom = chrom
        self.ww_min = ww_min
        self._sparse = sparse   # (dd, b1, cvals, ct) for lazy rebuilds
        self._cband = cband

    @property
    def cband(self):
        if self._cband is None:
            if self._sparse is None:
                raise AttributeError(
                    'cband needs the COO arrays; build with '
                    'keep_sparse=True (the production engine path drops '
                    'them — it derives the balanced band on device)')
            dd, b1, cvals, _ = self._sparse
            cb = np.zeros(self.raw.shape, np.float64)
            cb[dd, b1] = cvals
            cb[:self.ww_min, :] = 0.0
            self._cband = cb.astype(self.raw.dtype)
        return self._cband

    def candidate_total(self, d_lo, d_hi) -> int:
        """Host count of candidate pixels (nonzero raw, d_lo <= d <= d_hi)
        — the freeze emulation's global total (callers.py:101-104) without
        materializing the dense mask.  Uses the host-reduced global
        per-diagonal histogram when present (multi-host sharded bands hold
        only local pixels in ``_sparse``)."""
        if self.cand_hist is not None:
            h = self.cand_hist
            return int(h[d_lo:min(d_hi + 1, len(h))].sum())
        dd, _, _, ct = self._sparse
        return int(np.count_nonzero((dd >= d_lo) & (dd <= d_hi) & (ct != 0)))

    def nnz(self) -> int:
        """Global nonzero-pixel count (observability; api.py logging)."""
        if self.cand_hist is not None:
            return int(self.cand_hist.sum())
        _, _, _, ct = self._sparse
        return int(np.count_nonzero(ct))


CSUM_BLOCK = 128   # canonical csum column-block width (see fold below)


def blocked_csum(dd, b1, cvals, num_p, Lp):
    """Per-(diagonal, 128-column-block) balanced partial sums.

    Within a (d, block) cell, np.bincount accumulates in input (pixel)
    order — bin1-ascending for cooler-sorted pixels — matching the native
    band_build3's per-block loop and the sharded loader's per-span bincounts
    exactly."""
    nb = (Lp + CSUM_BLOCK - 1) // CSUM_BLOCK
    key = dd * nb + (b1 // CSUM_BLOCK)
    return np.bincount(key, weights=cvals,
                       minlength=num_p * nb).reshape(num_p, nb)


def fold_blocked_csum(blk):
    """Left fold of the blocked partial sums — THE canonical per-diagonal
    balanced sum.  Fixed 128-column blocks and a sequential left-to-right
    fold make the result bit-identical across the numpy, native-C++ and
    multi-host sharded loaders at any thread/process/mesh count (the
    float64 host-exact statistics derive the expected model from it;
    trailing all-zero padding blocks add +0.0 and change nothing)."""
    if blk.shape[1] == 0:
        return np.zeros(blk.shape[0])
    return np.cumsum(blk, axis=1)[:, -1]


def build_bands(bin1, bin2, count, weights, L, num, ww_min, res, chrom='',
                dtype=np.float32, lane_pad=128, sublane_pad=8,
                keep_sparse=True) -> ChromBands:
    """Scatter upper-triangle pixels into a zero-padded raw band tensor
    and derive the per-diagonal/per-bin vectors from the sparse arrays.

    Shapes are padded to TPU-friendly multiples; padding is semantically
    transparent because all engine reads treat out-of-band positions as
    zero, exactly like the reference's zero-extended diagonals
    (callers.py:50-64).
    """
    Lp = _round_up(max(L, 1), lane_pad)
    num_p = _round_up(max(num, 1), sublane_pad)
    w = np.asarray(weights, np.float64)

    native = None
    if dtype == np.float32 or np.dtype(dtype) == np.float32:
        from .bandnative import band_build_native
        native = band_build_native(bin1, bin2, count, w, L, num, num_p, Lp,
                                   ww_min, keep_sparse=keep_sparse)
    if native is not None:
        raw, csum_blk, nan_counts, colsum, sparse, cand_hist, max_count = \
            native
        csum = fold_blocked_csum(csum_blk)
    else:
        d = (bin2 - bin1).astype(np.int64)
        sel = (d >= 0) & (d < num) & (bin1 >= 0) & (bin2 < L)
        b1, dd, ct = bin1[sel], d[sel], count[sel].astype(np.float64)

        raw = np.zeros((num_p, Lp), dtype)
        raw[dd, b1] = ct

        wprod = w[b1] * w[b1 + dd]
        nanmask_vals = np.isnan(wprod)
        cvals = np.where(nanmask_vals, 0.0, ct * wprod)

        # NaN-aware per-diagonal means over the true extent [0, L-d):
        # sums/counts via O(nnz) bincounts — no dense balanced band needed.
        nan_counts = np.bincount(dd[nanmask_vals], minlength=num_p)[:num_p]
        csum = fold_blocked_csum(blocked_csum(dd, b1, cvals, num_p, Lp))
        in_rows = dd >= ww_min
        colsum = np.bincount(b1[in_rows], weights=cvals[in_rows],
                             minlength=Lp)[:Lp]
        cand_hist = np.bincount(dd[ct != 0], minlength=num_p)[:num_p]
        max_count = float(ct.max()) if ct.size else 0.0
        sparse = (dd, b1, cvals, ct) if keep_sparse else None

    diag_len = np.maximum(L - np.arange(num_p), 0)
    denom = diag_len - nan_counts
    with np.errstate(invalid='ignore', divide='ignore'):
        IR = csum / denom
    IR[:ww_min] = 0.0
    IR[num:] = 0.0

    # gap bins: zero columns of the balanced band (rows >= ww_min), the
    # reference's zero rows of cM (callers.py:238).  cvals >= 0, so a
    # column sum is zero iff every contribution is zero.
    gap = colsum == 0

    valid = ~((w == 0) | np.isnan(w))
    bias = np.zeros(Lp, np.float64)
    bias[:L][valid] = 1.0 / w[valid]
    w0 = np.zeros(Lp, np.float64)
    w0[:L][valid] = w[valid]
    nanw = np.zeros(Lp, bool)
    nanw[:L] = np.isnan(w)

    return ChromBands(raw=raw, IR=IR.astype(dtype), bias=bias.astype(dtype),
                      w0=w0.astype(dtype), gap=gap, L=L, num=num, res=res,
                      chrom=chrom, ww_min=ww_min, sparse=sparse,
                      nanw=nanw, cand_hist=np.asarray(cand_hist),
                      max_count=max_count, IR64=IR, bias64=bias, w064=w0)


def bands_from_cooler(clr, chrom, maxapart, maxww, ww_min, dtype=np.float32,
                      weight_name='weight', lane_pad=128,
                      keep_sparse=True, row_bucket=8) -> ChromBands:
    """One-stop chromosome loader mirroring the reference worker's prep
    (scripts/pyHICCUPS:139-168): num = maxapart//res + maxww + 1.
    ``lane_pad`` buckets the padded width (e.g. 4096) so chromosomes of
    similar size share compiled programs; ``row_bucket`` likewise buckets
    the band ROW count, which lets a multi-resolution pipeline share one
    executable set across resolutions (num varies with res; padded rows
    are all-zero and candidate-free, so they are semantically inert)."""
    res = clr.binsize
    lo, hi = clr.bin_range(chrom)
    L = hi - lo
    num = maxapart // res + maxww + 1
    b1, b2, ct = clr.pixels_for_chrom(chrom)
    w = clr.weights(chrom, weight_name)
    return build_bands(b1, b2, ct, w, L, num, ww_min, res,
                       chrom=chrom.lstrip('chr'), dtype=dtype,
                       lane_pad=lane_pad, keep_sparse=keep_sparse,
                       sublane_pad=max(8, row_bucket))
