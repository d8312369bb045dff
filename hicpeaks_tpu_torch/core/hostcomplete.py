"""Float64 host completion of the compacted pixels (torch-free).

The device keeps a slightly inflated superset of each background's
significant pixels and ships them compacted, together with the exact
integer (chunk, count) histogram.  This module finishes the reference's
statistics in float64 on the host, as ``hicpeaks_tpu`` does:

* ``host_chunk_qtab64`` / ``host_chunk_complete`` and
  ``host_bh_complete`` are copies of ``hicpeaks_tpu/ops/score.py:889-958``,
  whose module imports JAX;
* ``_compact_to_host`` is ``hicpeaks_tpu/core/engine.py:928-1036`` for the
  histogram bundles of the pyHICCUPS path (exact and suspect branches);
* ``_bhfdr_to_host`` is ``hicpeaks_tpu/core/engine.py:1124-1162`` for the
  global-BH bundle of the pyBHFDR path.

The exact branches recompute each pixel's E in float64
(:mod:`hicpeaks_tpu_torch.ops.hostexact`).  The histogram branch moves lambda-chunk
edge suspects to their float64 chunk and audits the device's count
thresholds against the corrected table; the global-BH branch ranks the
superset's float64 p-values among themselves.
"""
from __future__ import annotations

import numpy as np

from ..ops import hostexact

FALLBACK_ITEM = ('the non-fused fallback ladder (ROADMAP.md, Queue 1 '
                 'item 10) is not ported yet')


def host_chunk_qtab64(hist):
    """Exact float64 (chunk, count) BH tables (ptab, qtab) from the integer
    histogram.  The per-count p is the reference's own ``1 -
    poisson.cdf(count; right_edge)`` (callers.py:268-270), kept verbatim
    so the emitted digits match it, artifacts included."""
    from scipy.stats import poisson as _poisson
    hist = np.asarray(hist, np.int64)
    S, C = hist.shape
    m = hist.sum(axis=1, keepdims=True).astype(np.float64)
    rank_max = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1].astype(np.float64)
    rv = np.power(2.0, (np.arange(S, dtype=np.float64) - 1.0) / 3.0)[:, None]
    counts = np.arange(C, dtype=np.float64)[None, :]
    ptab = 1.0 - _poisson.cdf(counts, rv)
    qraw = np.where(rank_max > 0,
                    np.minimum(ptab * m / np.maximum(rank_max, 1.0), 1.0),
                    2.0)
    # within a chunk p decreases with the count, so BH's suffix-min is a
    # prefix-min over ascending counts
    qtab = np.minimum.accumulate(qraw, axis=1)
    return ptab, qtab


def host_chunk_complete(O_small, cid_small, hist):
    """Exact float64 (p, q) of compacted pixels by (chunk, count) lookup
    into the float64 tables of the full histogram; chunk 0 (the invalid
    trash row) carries p = q = 1."""
    ptab, qtab = host_chunk_qtab64(hist)
    S, C = qtab.shape
    oc = np.clip(np.floor(np.asarray(O_small, np.float64)).astype(np.int64),
                 0, C - 1)
    cs = np.clip(np.asarray(cid_small, np.int64), 0, S - 1)
    p, q = ptab[cs, oc], qtab[cs, oc]
    p[cs == 0] = 1.0
    q[cs == 0] = 1.0
    return p, q


def host_bh_complete(p_small, ranks, m, sig):
    """Exact float64 global-BH q-values of the compacted superset (p,
    global rank, m): tied p share the tie group's max rank, and the
    ascending-p suffix-min over the superset equals the full suffix-min for
    every pixel whose true q <= sig."""
    p = np.asarray(p_small, np.float64)
    r = np.asarray(ranks, np.float64)
    raw = np.minimum(p * float(m) / np.maximum(r, 1.0), 1.0)
    order = np.argsort(p, kind='stable')
    q_sorted = np.minimum.accumulate(raw[order][::-1])[::-1]
    q = np.empty_like(q_sorted)
    q[order] = q_sorted
    return q


def _bhfdr_to_host(fetched, prod, sig, exact=None):
    """The pyBHFDR bundle -> host dict of its significant pixels (x, y, O,
    ICE, Fold, p, q, prod), with exact float64 p and q.

    ``fetched`` = (cnt, d_idx, x_idx, O, ICE, Fold, p, E, m, gap) as numpy
    arrays: the device's keep superset in row-major order, its f32 p (not
    read: p is recomputed), E, the valid count m and the gap flags.
    ``exact`` = (ExactCtx, p, kind) replays the ring sums in float64."""
    cnt, d_idx, x_idx, Ov, ICEv, Foldv, _pv, Ev, m, gapv = fetched
    n = int(cnt)
    d_idx, x_idx = d_idx[:n], x_idx[:n]
    # float64 p as the reference writes it, 1 - cdf (callers.py:541), tail
    # saturation included
    from scipy.stats import poisson as _poisson
    Ovn, ICEn, Foldn = Ov[:n], ICEv[:n], Foldv[:n]
    E64 = np.asarray(Ev[:n], np.float64)
    if exact is not None:
        ctx, p_set, kind = exact
        Ovn, E64, Foldn, ICEn = hostexact.exact_stats(
            ctx, d_idx, x_idx, p_set, kind)
    p64 = 1.0 - _poisson.cdf(np.floor(np.asarray(Ovn, np.float64)), E64)
    # every pixel with p64 <= tau is in the superset, and so is every pixel
    # whose p64 is below it: the rank #{j: p64_j <= p64_i} of any pixel
    # that can be kept counts superset members only
    p_sorted = np.sort(p64, kind='stable')
    ranks64 = np.searchsorted(p_sorted, p64, side='right')
    q = host_bh_complete(p64, ranks64, m, sig)
    # the gap filter comes after BH (callers.py:556-577): gap pixels took
    # part in the ranks and the suffix-min, and leave only here
    fin = (q <= sig) & ~np.asarray(gapv[:n], bool)
    return dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin], O=Ovn[fin],
                ICE=ICEn[fin], Fold=Foldn[fin], p=p64[fin], q=q[fin],
                prod=prod)


def _compact_to_host(fetched, prod, sig, exact=None, sus=None):
    """One background's fetched bundle -> host dict of its significant
    pixels (x, y, O, ICE, Fold, p, q, prod).

    ``fetched`` = (cnt, d_idx, x_idx, O, ICE, Fold, cid, hist) as numpy
    arrays; ``prod`` is the device handle the postcheck reads.  ``exact`` =
    (ExactCtx, p, kind) recomputes the statistics in float64; ``sus`` is
    the fetched suspect bundle (cnt, d, x, cid, O, gap, thr).  A corrected
    table that could hide a missed pixel raises NotImplementedError: the
    dense fallback scorer it needs is not ported."""
    cnt, d_idx, x_idx, Ov, ICEv, Foldv, cid, hist = fetched
    n = int(cnt)
    d_idx, x_idx = d_idx[:n], x_idx[:n]
    if exact is None:
        p64, q64 = host_chunk_complete(Ov[:n], cid[:n], hist)
        fin = q64 <= sig
        return dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin], O=Ov[:n][fin],
                    ICE=ICEv[:n][fin], Fold=Foldv[:n][fin], p=p64[fin],
                    q=q64[fin], prod=prod)

    ctx, p_set, kind = exact
    hist64 = np.asarray(hist, np.int64)
    S, C = hist64.shape
    sus_data = None
    if sus is not None:
        ns = int(sus[0])
        ds, xs = sus[1][:ns], sus[2][:ns]
        # the device folded chunks >= S into overflow row S-1, so the
        # subtraction targets the row the pixel actually occupies
        cid_dev = np.clip(np.asarray(sus[3][:ns], np.int64), 0, S - 1)
        O_s = np.asarray(sus[4][:ns], np.int64)
        gap_s = np.asarray(sus[5][:ns], bool)
        thr_dev = np.asarray(sus[6], np.int64)
        O64s, E64s, fold64s, ice64s = hostexact.exact_stats(
            ctx, ds, xs, p_set, kind)
        cid64s, valid64s = hostexact.chunk_ids64(E64s, E64s > 0)
        cid_new = np.where(valid64s, np.clip(cid64s, 0, S - 1), 0)
        # move each suspect from its device (chunk, count) cell to its
        # float64 one (row 0 = the invalid trash row, both ways)
        np.add.at(hist64, (cid_dev, O_s), -1)
        np.add.at(hist64, (cid_new, O_s), 1)
        sus_data = (ds, xs, cid_new, O_s, gap_s, O64s, fold64s, ice64s,
                    valid64s, thr_dev)
    O64, E64, fold64, ice64 = hostexact.exact_stats(
        ctx, d_idx, x_idx, p_set, kind)
    cid64, valid64 = hostexact.chunk_ids64(E64, E64 > 0)
    ptab, qtab = host_chunk_qtab64(hist64)
    oc = np.clip(np.floor(O64).astype(np.int64), 0, C - 1)
    cs = np.clip(cid64, 0, S - 1)
    p64 = np.where(valid64, ptab[cs, oc], 1.0)
    q64 = np.where(valid64, qtab[cs, oc], 1.0)
    fin = q64 <= sig
    out = dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin], O=O64[fin],
               ICE=ice64[fin], Fold=fold64[fin], p=p64[fin], q=q64[fin],
               prod=prod)
    if sus_data is None:
        return out
    (ds, xs, cid_new, O_s, gap_s, O64s, fold64s, ice64s, valid64s,
     thr_dev) = sus_data
    # audit the device superset against the CORRECTED table: a cell that
    # is significant below the device's count threshold and still holds
    # non-suspect pixels could hide a missed peak (row 0 is the trash row)
    hist_nosus = hist64.copy()
    np.add.at(hist_nosus, (cid_new, O_s), -1)
    counts_i = np.arange(C, dtype=np.int64)[None, :]
    missed = ((qtab <= sig) & (counts_i < thr_dev[:, None])
              & (hist_nosus > 0))
    missed[0, :] = False
    if missed.any():
        raise NotImplementedError(
            f'suspect-corrected BH table made {int(missed.sum())} (chunk, '
            'count) cells significant below the device keep threshold; '
            'the dense scorer that resolves this is part of '
            + FALLBACK_ITEM)
    p64s = np.where(valid64s, ptab[cid_new, O_s], 1.0)
    q64s = np.where(valid64s, qtab[cid_new, O_s], 1.0)
    fin_s = (q64s <= sig) & ~gap_s
    return dict(
        x=np.concatenate([out['x'], xs[fin_s]]),
        y=np.concatenate([out['y'], xs[fin_s] + ds[fin_s]]),
        O=np.concatenate([out['O'], O64s[fin_s]]),
        ICE=np.concatenate([out['ICE'], ice64s[fin_s]]),
        Fold=np.concatenate([out['Fold'], fold64s[fin_s]]),
        p=np.concatenate([out['p'], p64s[fin_s]]),
        q=np.concatenate([out['q'], q64s[fin_s]]),
        prod=prod)
