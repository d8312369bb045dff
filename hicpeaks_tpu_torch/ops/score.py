"""Sheets, the batched lambda-chunk scorer and global BH in PyTorch.

Port of the parts of ``hicpeaks_tpu/ops/score.py`` that the pyHICCUPS and
pyBHFDR paths run: the sheet derivation (``_build_sheets_jit`` for a float
raw slab), the gap filter, expected values, lambda chunks and their edge
suspects, the (chunk, count) histogram BH keep mask, its q table, the
sort-free global BH keep superset, segmented BH by a sort (the scorer of
counts above the histogram's cap), and the keep-mask compaction.  Dtypes
follow JAX's: the raw slab becomes float32,
every other sheet keeps its vector's dtype, so float64 bands compute what
the JAX package computes under its x64 flag.

What the port leaves out, and why: the TPU transfer encodings
(``_unpack_rows``), the split histogram (``chunk_hist_split`` cut MXU work;
an atomic histogram's cost does not grow with the column count) and the
fixed-cap compaction tiers (``torch.nonzero`` sizes the output from the
count).  Each read the host blocks on (an op sized by the data, a Python
number of a tensor) is a ``hicpeaks.sync`` span (``core/spans``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.spans import SYNC, span
from .cuda_hist import chunk_hist


def shear_bcast(vec, num_p, c0=0, width=None):
    """out[d, x] = vec[c0 + x + d] for x < ``width`` (default: the rest of
    the vector), zero beyond the end: a strided re-read of the zero-padded
    vector (row d starts one element later per row).  ``c0`` is a column
    tile's offset in the chromosome."""
    seg = vec[c0:]
    width = seg.shape[0] if width is None else width
    pad = num_p + max(0, width - seg.shape[0])
    wpad = torch.cat([seg, seg.new_zeros(pad)])
    return wpad.as_strided((num_p, width), (1, 1))


def _shift1(A, k):
    """out[i] = A[i+k], zero outside bounds."""
    n = A.shape[0]
    if k == 0:
        return A
    if abs(k) >= n:
        return torch.zeros_like(A)
    if k > 0:
        return torch.cat([A[k:], A.new_zeros(k)])
    return torch.cat([A.new_zeros(-k), A[:k]])


def gap_reject_device(gap, num_p, L, s, c0=0, width=None):
    """drop[d, x] = any gap bin inside the reference's exclusive-upper
    windows around x or y = x + d (callers.py:291-312); the twin of
    ``hicpeaks_tpu.ops.score.gap_reject_device``.  ``gap`` is the whole
    chromosome's vector; ``c0`` and ``width`` select a column tile."""
    Lp = gap.shape[0]
    pos = torch.arange(Lp, device=gap.device)
    g = (gap & (pos < L)).to(torch.int32)
    A = torch.cumsum(g, 0, dtype=torch.int32)         # A[i] = G[i+1]
    total = A[-1]
    g_last = torch.where(pos == L - 1, g, 0).sum(dtype=torch.int32)
    # upper branch pos+s < L: G[pos+s] = A[pos+s-1]; else G[L-1]
    Gu = torch.where(pos + s < L, _shift1(A, s - 1), total - g_last)
    # lower branch pos > s: G[pos-s] = A[pos-s-1]; else G[0] = 0
    Gl = torch.where(pos > s, _shift1(A, -(s + 1)), 0)
    cnt = torch.where(pos < L, Gu - Gl, 0)
    width = Lp - c0 if width is None else width
    return _rowmajor(torch.add, _cols(cnt, c0, width)[None, :],
                     shear_bcast(cnt, num_p, c0, width)) > 0


def _rowmajor(op, a, b):
    """``op(a, b)`` of two 2-D tensors into a new row-major tensor: a
    broadcast with the sheared view would otherwise take the view's
    column-major layout."""
    out = torch.empty(tuple(map(max, a.shape, b.shape)),
                      dtype=torch.result_type(a, b), device=a.device)
    return op(a, b, out=out)


def _cols(vec, c0, width):
    """vec[c0:c0 + width], zero past the vector's end."""
    seg = vec[c0:c0 + width]
    if seg.shape[0] < width:
        seg = torch.cat([seg, seg.new_zeros(width - seg.shape[0])])
    return seg


def build_sheets(raw, w0, bias, IR, gap, ww_min, L, d_lo, d_hi, gap_s,
                 c0=0):
    """Every dense sheet the engine needs, from one raw slab and O(L)
    vectors (``_build_sheets_jit``): returns (raw f32, cband, eband, Bprod,
    gap_drop, cand).  The multiply order ``raw * w0[x] * w0[x+d]`` is
    JAX's, so float32 sheets are bit-identical to it.

    ``raw`` may be a column tile starting at chromosome column ``c0``; the
    vectors ``w0``, ``bias`` and ``gap`` are always the whole chromosome's
    (a tile's sheets read them past its right edge)."""
    num_p, T = raw.shape
    dev = raw.device
    drow = torch.arange(num_p, device=dev)[:, None]
    col = c0 + torch.arange(T, device=dev)[None, :]

    raw = raw.to(torch.float32)
    cband = raw * _cols(w0, c0, T)[None, :] * shear_bcast(w0, num_p, c0, T)
    cband = torch.where(drow < ww_min, 0.0, cband)
    eband = torch.where(col < (L - drow), IR[:, None], 0.0)
    Bprod = _rowmajor(torch.mul, _cols(bias, c0, T)[None, :],
                      shear_bcast(bias, num_p, c0, T))
    gap_drop = gap_reject_device(gap, num_p, L, gap_s, c0, T)
    cand = (raw != 0) & (drow >= d_lo) & (drow <= d_hi)
    return raw, cband, eband, Bprod, gap_drop, cand


def expected_observed(raw, cband, IR, Bprod, bSV, bEV, wi, cand_mask, L,
                      c0=0):
    """E, O, ICE, Fold, the scored mask and the raw EM*ratio product (the
    hiccups Y-background postcheck reads it, callers.py:329-331).
    ``bSV``/``bEV``/``wi`` may carry a leading batch axis.  ``c0``: the
    chromosome column of the sheets' first column (a column tile's
    offset)."""
    num_p, Lp = raw.shape
    dev = raw.device
    drow = torch.arange(num_p, device=dev)[:, None]
    col = c0 + torch.arange(Lp, device=dev)[None, :]
    EM = torch.where(col < (L - drow), IR[:, None], 0.0)

    mask = (bEV != 0) & (drow >= wi) & cand_mask
    ratio = torch.where(mask, bSV / torch.where(bEV != 0, bEV, 1.0), 0.0)
    prod = EM * ratio

    E = prod * Bprod
    scored = (prod != 0) & (E > 0)
    Fold = torch.where(scored, raw / torch.where(scored, E, 1.0), 0.0)
    return E, raw, cband, Fold, scored, prod


def poisson_sf(O, lam):
    """P(X > O) for X ~ Poisson(lam), X's CDF evaluated at floor(O)."""
    return torch.special.gammainc(torch.floor(O) + 1.0, lam)


def _log2_t(E, scored):
    """(safeE, t = 3*log2(E)) in JAX's operation order."""
    safeE = torch.where(scored & (E > 0), E, 1.0)
    ln2 = torch.tensor(math.log(2.0), dtype=E.dtype, device=E.device)
    return safeE, 3.0 * (torch.log(safeE) / ln2)


def chunk_edges(c, dtype):
    """(left, right) edges of chunk ids ``c``: 0 and 2^((c-1)/3) for chunk
    1, else 2^((c-2)/3) and 2^((c-1)/3), in ``dtype``."""
    lv = torch.where(c == 1, 0.0, torch.pow(2.0, (c - 2).to(dtype) / 3.0))
    return lv, torch.pow(2.0, (c - 1).to(dtype) / 3.0)


def lambda_chunks(E, scored):
    """Chunk id per pixel: chunk i covers the OPEN interval
    (2^((i-2)/3), 2^((i-1)/3)), chunk 1 is (0, 1); pixels exactly on an
    edge belong to no chunk (callers.py:38).  Returns (cid, right_edge,
    valid)."""
    safeE, t = _log2_t(E, scored)
    cid = torch.floor(t).to(torch.int32) + 2
    cid = torch.clamp(cid, min=1)
    # float-rounding guard: nudge into the neighbouring chunk when the
    # computed id misses the strict-open membership test
    lv, rv = chunk_edges(cid, E.dtype)
    cid = torch.where((safeE <= lv) & (cid > 1), cid - 1,
                      torch.where(safeE >= rv, cid + 1, cid))
    lv, rv = chunk_edges(cid, E.dtype)
    valid = scored & (safeE > lv) & (safeE < rv)
    return cid, rv, valid


def lambda_suspects(E, scored, margin):
    """Pixels whose lambda-chunk membership is not provably the float64
    one: ``t = 3*log2(E)`` within ``margin`` of an integer (see
    ``hicpeaks_tpu.ops.score.lambda_suspects``)."""
    _, t = _log2_t(E, scored)
    return scored & (torch.abs(t - torch.round(t)) < margin)


def chunk_rows(o_cap, sig=0.05):
    """Chunk-row count sufficient for exact histogram BH at this count cap
    (``hicpeaks_tpu.ops.score.chunk_rows``: every chunk whose right edge is
    >= 2*o_cap folds into the overflow row S-1 without changing any
    emitted statistic)."""
    if not o_cap or o_cap < 1024 or sig > 0.2:
        return 128
    s = int(math.ceil(3 * math.log2(o_cap))) + 5
    return min(128, -(-s // 8) * 8)


def qtab_from_hist(hist2, dtype, period=None):
    """BH q table from the exact integer histogram; ``period``: the
    Poisson right edge of row r is that of local chunk ``r % period``."""
    S, C = hist2.shape
    dev = hist2.device
    m = hist2.sum(dim=1, keepdim=True).to(dtype)
    # rank_max(s, O): pixels with count >= O  (descending-O cumulative)
    rank_max = torch.flip(torch.cumsum(torch.flip(hist2, (1,)), 1),
                          (1,)).to(dtype)
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    if period is not None:
        ids = ids % period
    rv = torch.pow(2.0, (ids.to(dtype) - 1.0) / 3.0)[:, None]
    counts = torch.arange(C, dtype=dtype, device=dev)[None, :]
    ptab = poisson_sf(counts, rv)
    # empty buckets carry a finite sentinel > 1; real q-values are <= 1
    qraw = torch.where(rank_max > 0,
                       torch.clamp(ptab * m / torch.clamp(rank_max, min=1.0),
                                   max=1.0),
                       2.0)
    return torch.cummin(qraw, dim=1).values


def chunk_pack(O, cid, valid, S, C):
    """The histogram's inputs from one sheet: int32 counts ``clamp(floor(O),
    0, C-1)`` [n] and int32 chunk ids [B, n], ``clamp(cid, 1, S-1)`` where
    valid and 0 (the trash row) elsewhere; ``O`` is [num_p, Lp], ``cid``
    and ``valid`` [B, num_p, Lp]."""
    B = cid.shape[0]
    Oc = torch.clamp(torch.floor(O), 0, C - 1)
    cid0 = torch.where(valid, torch.clamp(cid, 1, S - 1), 0)
    return Oc.to(torch.int32).reshape(-1), cid0.reshape(B, -1)


def chunk_thresholds(hist, B, S, sig, slack, dtype):
    """The q table [B*S, C] of the summed histogram and each (background,
    chunk)'s keep threshold: the least count whose q is <= ``sig * (1 +
    slack)``, int32 [B, S] (q is nonincreasing in the count within a
    chunk, so ``q <= sig`` is ``count >= thr[chunk]``)."""
    qtab = qtab_from_hist(hist, dtype, period=S)
    sig_t = torch.tensor(sig, dtype=dtype, device=hist.device)
    thr = (qtab > sig_t * (1.0 + slack)).to(dtype).sum(dim=1)
    return qtab, thr.reshape(B, S)


def chunk_keep(O, cid, valid, thr2, sig, C):
    """Histogram BH's keep mask [B, ...] from the thresholds of
    :func:`chunk_thresholds`: the per-pixel threshold is the gather
    ``thr2[b, clamp(cid, 1, S-1)]``, the same integer JAX forms as a
    telescoping broadcast-sum."""
    B, S = thr2.shape
    Oc = torch.clamp(torch.floor(O), 0, C - 1)
    cidc = torch.clamp(cid, 1, S - 1)
    th = torch.gather(thr2, 1, cidc.reshape(B, -1).to(torch.int64)) \
        .reshape(cid.shape)
    keep = valid & (Oc >= th)
    sig_t = torch.tensor(sig, dtype=O.dtype, device=O.device)
    return keep | (~valid & (sig_t >= 1.0))


def global_bh_keep(pval, valid, sig, count_sum=None):
    """Sort-free keep SUPERSET for global (pyBHFDR) BH: the fixed point of
    ``t <- sig * #{p <= t} / m``, started at ``t = sig`` and inflated by
    1e-4 relative at every step, so the mask holds every pixel of the exact
    rejection set however the threshold rounds (see
    ``hicpeaks_tpu.ops.score.global_bh_keep``).  The host recomputes the
    kept pixels' q in float64 (``core.hostcomplete._bhfdr_to_host``).

    ``sig`` passes through float32 first, as the JAX engine hands it over
    (``jnp.float32(cfg.siglevel)``), and every threshold is computed in
    ``pval.dtype`` in JAX's order ``sig * k / m * 1.0001``, so the mask is
    bit-equal to JAX's on the same p-values.  Each loop test is a host
    sync; the loop ends when the count stops changing.

    ``pval`` and ``valid`` may be lists of column tiles; ``count_sum``
    then reduces a list of per-tile integer counts to the chromosome's
    (``parallel.tiles.psum``), once per step, and ``keep`` is a list.

    Returns (keep, m, iterations) with m the valid count in ``pval.dtype``
    and ``iterations`` the number of fixed-point steps."""
    tiled = isinstance(pval, (list, tuple))
    pvals, valids = (pval, valid) if tiled else ([pval], [valid])
    count_sum = count_sum or (lambda parts: parts[0])
    dt = pvals[0].dtype
    dev = count_sum([v.sum() for v in valids]).device
    infl = torch.tensor(1.0001, dtype=dt, device=dev)
    sigf = torch.tensor(sig, dtype=torch.float32).to(dt).to(dev)
    m = count_sum([v.sum() for v in valids]).to(dt)
    msafe = torch.clamp(m, min=1.0)

    def below(t):
        return [v & (p <= t.to(p.device)) for p, v in zip(pvals, valids)]

    def count(t):
        return count_sum([k.sum() for k in below(t)]).to(dt)

    k = count(sigf * infl)
    iterations = 0
    while True:
        k_next = count(sigf * k / msafe * infl)
        iterations += 1
        with span(SYNC):
            done = bool(k_next == k)
        if done:
            break
        k = k_next
    keep = below(sigf * k / msafe * infl)
    return (keep if tiled else keep[0]), m, iterations


def segmented_bh(pvals, seg, valid):
    """Benjamini-Hochberg q-values within each segment of ``seg`` (int
    ids), restricted to ``valid``; invalid entries get q = 1
    (``hicpeaks_tpu.ops.score.segmented_bh``, statsmodels' fdr_bh within
    a segment of size m: q = cummin-from-largest(p_sorted * m / rank),
    clipped to 1).

    The valid entries go in (segment, p, index) order, the order of JAX's
    two-key ``lax.sort``: a stable sort by p, then a stable sort by
    segment.  Tied p share one q whatever their order, since the suffix
    min runs over the tie.  One suffix min per segment (at most 128
    lambda chunks)."""
    p = pvals.reshape(-1)
    with span(SYNC):
        flat = torch.nonzero(valid.reshape(-1)).reshape(-1)
    pv = p[flat]
    sv = seg.reshape(-1)[flat]
    o = torch.argsort(pv, stable=True)
    o = o[torch.argsort(sv[o], stable=True)]
    ps = pv[o]
    q = torch.empty_like(ps)
    with span(SYNC):
        _, sizes = torch.unique_consecutive(sv[o], return_counts=True)
    with span(SYNC):
        sizes = sizes.tolist()
    start = 0
    for m in sizes:
        rank = torch.arange(1, m + 1, device=p.device).to(ps.dtype)
        qc = torch.clamp(ps[start:start + m] * m / rank, max=1.0)
        q[start:start + m] = torch.flip(
            torch.cummin(torch.flip(qc, (0,)), 0).values, (0,))
        start += m
    out = torch.ones_like(p)
    out[flat[o]] = q
    return out.reshape(pvals.shape)


def compact_mask_batched(keep):
    """Row-major (d, x) indices of each background's True cells.

    Returns (count [B] int32, d_idx [B, K], x_idx [B, K]) with K the
    largest count; entries past a background's count point at the last
    cell, as in ``hicpeaks_tpu.ops.score.compact_mask_batched``."""
    B, R, C = keep.shape
    with span(SYNC):
        nz = torch.nonzero(keep.reshape(B, -1))      # row-major (b, flat)
    with span(SYNC):   # on a card, bincount reads its input's min and max
        cnt = torch.bincount(nz[:, 0], minlength=B).to(torch.int32)
    with span(SYNC):
        K = int(cnt.max())
    pos = torch.full((B, K), R * C - 1, dtype=torch.int64,
                     device=keep.device)
    start = torch.cumsum(cnt, 0) - cnt
    slot = torch.arange(nz.shape[0], device=keep.device) \
        - start.to(torch.int64)[nz[:, 0]]
    pos[nz[:, 0], slot] = nz[:, 1]
    return cnt, (pos // C).to(torch.int32), (pos % C).to(torch.int32)


def compact_mask(keep):
    """Row-major (d, x) indices of the True cells of one [R, C] mask:
    (count int32, d_idx [count], x_idx [count]), with no cap."""
    cnt, d_idx, x_idx = compact_mask_batched(keep[None])
    return cnt[0], d_idx[0], x_idx[0]


class Suspects(NamedTuple):
    """The batched scorer's lambda-chunk edge suspects, set aside for
    float64 completion, each field with a leading [B] axis."""
    cnt: object     # int32 [B] suspects a background
    d: object       # int32 [B, Ks] row-major, the last cell past the count
    x: object
    cid: object     # int32 device chunk
    O: object       # int32 device count, clamp(floor(O), 0, o_cap)
    gap: object     # bool gap flag
    thr: object     # int32 [B, S] keep thresholds


class Compacted(NamedTuple):
    """The batched pyHICCUPS scorer's hand-off to completion, each field
    with a leading [B] axis: tensors on the device, numpy arrays once
    fetched (``engine._to_host``)."""
    cnt: object     # int32 [B] kept pixels a background
    d: object       # int32 [B, K] row-major, the last cell past the count
    x: object
    O: object
    ICE: object
    Fold: object
    cid: object     # int32 device chunk, 0 where not valid
    hist: object    # int32 [B, S, C] (chunk, count) histogram
    prod: object    # the postcheck's [B, num_p, Lp] or its handle; not fetched
    sus: object     # Suspects; None without float64 completion


def one_background(rec, b):
    """Background ``b`` of a record: row ``b`` of each field, a nested
    record's too; a field that is None stays None."""
    return type(rec)._make(
        a if a is None else one_background(a, b) if isinstance(a, tuple)
        else a[b] for a in rec)
