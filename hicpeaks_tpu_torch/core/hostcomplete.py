"""Float64 host completion of the compacted pixels, in numpy (torch only
marks its trace spans, :mod:`.spans`).

The device keeps a slightly inflated superset of each background's
significant pixels and ships them compacted, together with the exact
integer (chunk, count) histogram.  This module finishes the reference's
statistics in float64 on the host, as ``hicpeaks_tpu`` does:

* ``host_chunk_qtab64`` and ``host_bh_complete`` are copies of
  ``hicpeaks_tpu/ops/score.py:889-958``, and ``host_chunk_dense`` /
  ``host_bh`` of ``:961-1016``, whose module imports JAX; the batched
  scorer's (S, C) p table is scipy's, made once a shape (:func:`ptab64`);
* ``_compact_to_host`` is ``hicpeaks_tpu/core/engine.py:928-1036`` for the
  batched scorer's ``ops.score.Compacted`` (exact and suspect branches; p
  and q looked up as ``host_chunk_complete`` does), and
  ``_segmented_to_host`` for the segmented-BH bundle, whose device p and
  q it emits as they are;
* ``_bhfdr_to_host`` is ``hicpeaks_tpu/core/engine.py:1124-1162`` for the
  global-BH bundle of the pyBHFDR path;
* ``_dense_to_host`` is the host half of the dense scorer
  (``hicpeaks_tpu/core/engine.py:1230-1259``) on the fetched valid pixels.

Which routes complete here: pyBHFDR (its p is a per-pixel ``1 -
poisson.cdf`` with a continuous E, so no table serves it), the dense
scorer, checkify's per-background scorer, segmented BH, the tiles of a
mesh, and the batched pyHICCUPS scorer without float64 completion.  With
it, the batched pyHICCUPS scorer on one device completes on that device
(:mod:`.complete64`), with the same numbers; its CPU twin runs this
module's table steps (:func:`chunk_qtab`, :func:`move_suspects`,
:func:`audit`, :func:`lookup`).

The exact branches recompute each pixel's E in float64
(:mod:`hicpeaks_tpu_torch.ops.hostexact`).  The histogram branch moves lambda-chunk
edge suspects to their float64 chunk and audits the device's count
thresholds against the corrected table; the global-BH branch ranks the
superset's float64 p-values among themselves.
"""
from __future__ import annotations

import functools
import logging

import numpy as np

from ..ops import hostexact
from .spans import span

log = logging.getLogger(__name__)


def _ptab(S, C):
    """The (chunk, count) p table of ``S`` chunks and ``C`` counts: the
    reference's own ``1 - poisson.cdf(count; right_edge)``
    (callers.py:268-270), kept verbatim so the emitted digits match it,
    artifacts included."""
    from scipy.stats import poisson as _poisson
    rv = np.power(2.0, (np.arange(S, dtype=np.float64) - 1.0)
                  / 3.0)[:, None]
    counts = np.arange(C, dtype=np.float64)[None, :]
    return 1.0 - _poisson.cdf(counts, rv)


@functools.lru_cache(maxsize=4)
def ptab64(S, C):
    """:func:`_ptab` of the batched scorer, made once a shape and kept
    (read-only): its S and C follow the count cap ``o_cap``, which takes a
    handful of values in a process."""
    ptab = _ptab(S, C)
    ptab.flags.writeable = False
    return ptab


def chunk_qtab(hist, ptab):
    """The BH q table of the int64 [S, C] histogram ``hist`` and its p
    table: per-chunk m and rank_max, then ``min(p * m / rank_max, 1)``
    (2 where no pixel ranks) and its prefix minimum."""
    m = hist.sum(axis=1, keepdims=True).astype(np.float64)
    rank_max = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1].astype(np.float64)
    qraw = np.where(rank_max > 0,
                    np.minimum(ptab * m / np.maximum(rank_max, 1.0), 1.0),
                    2.0)
    # within a chunk p decreases with the count, so BH's suffix-min is a
    # prefix-min over ascending counts
    return np.minimum.accumulate(qraw, axis=1)


def host_chunk_qtab64(hist):
    """Exact float64 (chunk, count) BH tables (ptab, qtab) from the integer
    histogram."""
    with span('hicpeaks.qtab64'):
        hist = np.asarray(hist, np.int64)
        ptab = _ptab(*hist.shape)
        return ptab, chunk_qtab(hist, ptab)


def move_suspects(hist, dev, new):
    """An int64 copy of the [S, C] histogram ``hist`` with each suspect
    moved from its device (chunk, count) cell to its float64 one (``dev``
    and ``new``: (chunks, counts) index pairs; row 0 is the invalid trash
    row, both ways)."""
    hist64 = np.array(hist, np.int64)
    np.add.at(hist64, dev, -1)
    np.add.at(hist64, new, 1)
    return hist64


def audit(qtab, hist64, new, thr_dev, sig):
    """The cells of the CORRECTED table that are significant below the
    device's count thresholds ``thr_dev`` [S] and still hold non-suspect
    pixels (the suspects sit at ``new``): each could hide a missed peak.
    Row 0 is the trash row."""
    hist_nosus = hist64.copy()
    np.add.at(hist_nosus, new, -1)
    counts_i = np.arange(qtab.shape[1], dtype=np.int64)[None, :]
    missed = ((qtab <= sig) & (counts_i < np.asarray(thr_dev)[:, None])
              & (hist_nosus > 0))
    missed[0, :] = False
    return int(missed.sum())


def log_failed_audit(missed):
    """Log the ``missed`` cells of a background's failed audit, which
    sends it to the dense scorer; returns None, its completion."""
    log.warning(
        'suspect-corrected BH table made %d (chunk, count) cells '
        'significant below the device keep threshold — falling back '
        'to the dense scorer for this background (f32-chunked; loci '
        'unaffected)', missed)


def lookup(ptab, qtab, cells, valid):
    """float64 p and q of the (chunks, counts) ``cells``, 1 where not
    ``valid``."""
    return (np.where(valid, ptab[cells], 1.0),
            np.where(valid, qtab[cells], 1.0))


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


def host_chunk_dense(O, cid, valid, sig):
    """Float64 p/q/keep for the DENSE fallback path (keep-cap overflow or
    an explicit host BH request): the exact-histogram completion of
    :func:`_compact_to_host` computed entirely from fetched dense
    arrays.  Returns (p64, q64, keep) dense arrays (p = q = 1 where
    invalid)."""
    O = np.asarray(O)
    c = np.clip(np.asarray(cid), 0, 127).astype(np.int64)
    v = np.asarray(valid)
    oc = np.floor(np.asarray(O, np.float64)).astype(np.int64)
    np.clip(oc, 0, None, out=oc)
    C = int(oc[v].max()) + 1 if v.any() else 1
    oc = np.minimum(oc, C - 1)
    S = 128
    hist = np.bincount((c[v] * C + oc[v]).ravel(),
                       minlength=S * C).reshape(S, C)
    ptab, qtab = host_chunk_qtab64(hist)
    p = np.ones(O.shape, np.float64)
    q = np.ones(O.shape, np.float64)
    p[v] = ptab[c[v], oc[v]]
    q[v] = qtab[c[v], oc[v]]
    return p, q, v & (q <= sig)


def host_bh(pvals, cids, valid):
    """Per-chunk Benjamini-Hochberg on the host (numpy): exact statsmodels
    fdr_bh semantics, no device sort.  Returns a dense q array (1 where
    invalid)."""
    p = np.asarray(pvals, np.float64)
    c = np.asarray(cids)
    v = np.asarray(valid)
    q = np.ones_like(p)
    flat_idx = np.nonzero(v.ravel())[0]
    if flat_idx.size == 0:
        return q
    pv = p.ravel()[flat_idx]
    cv = c.ravel()[flat_idx]
    order = np.lexsort((pv, cv))
    pv_s = pv[order]
    cv_s = cv[order]
    qs = np.empty_like(pv_s)
    boundaries = np.nonzero(np.diff(cv_s))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [cv_s.size]])
    for s, e in zip(starts, ends):
        m = e - s
        raw = pv_s[s:e] * m / np.arange(1, m + 1)
        qs[s:e] = np.minimum(1.0, np.minimum.accumulate(raw[::-1])[::-1])
    out_sorted = np.empty_like(qs)
    out_sorted[order] = qs
    q.ravel()[flat_idx] = out_sorted
    return q


def _dense_to_host(fetched, prod, sig, chunked):
    """The dense scorer's host half on every valid pixel of one
    background, fetched in row-major order as (d, x, O, ICE, Fold, cid, E,
    gap): float64 p and q over all of them, the gap filter after BH, and
    the host dict of the kept pixels with the device's O, ICE and Fold.

    ``chunked``: per-chunk histogram BH on the device chunk ids
    (:func:`host_chunk_dense`); else one global BH of ``1 - poisson.cdf``
    (callers.py:541), as the dense route of pyBHFDR computes it."""
    with span('hicpeaks.host_complete'):
        d_idx, x_idx, Ov, ICEv, Foldv, cid, Ev, gapv = fetched
        valid = np.ones(Ov.shape, bool)
        if chunked:
            p64, q64, keep = host_chunk_dense(Ov, cid, valid, sig)
        else:
            from scipy.stats import poisson as _poisson
            p64 = 1.0 - _poisson.cdf(np.floor(np.asarray(Ov, np.float64)),
                                     np.asarray(Ev, np.float64))
            q64 = host_bh(p64, valid.astype(np.int32), valid)
            keep = q64 <= sig
        keep = keep & ~np.asarray(gapv, bool)
        return dict(x=x_idx[keep], y=x_idx[keep] + d_idx[keep], O=Ov[keep],
                    ICE=ICEv[keep], Fold=Foldv[keep], p=p64[keep], q=q64[keep],
                    prod=prod)


def _bhfdr_to_host(fetched, prod, sig, exact=None):
    """The pyBHFDR bundle -> host dict of its significant pixels (x, y, O,
    ICE, Fold, p, q, prod), with exact float64 p and q.

    ``fetched`` = (cnt, d_idx, x_idx, O, ICE, Fold, p, E, m, gap) as numpy
    arrays: the device's keep superset in row-major order, its f32 p (not
    read: p is recomputed), E, the valid count m and the gap flags.
    ``exact`` = (ExactCtx, p, kind) replays the ring sums in float64."""
    with span('hicpeaks.host_complete'):
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


def _segmented_to_host(fetched, prod):
    """The segmented-BH bundle (cnt, d_idx, x_idx, O, ICE, Fold, p, q) of
    one background's kept pixels, fetched as numpy arrays -> its host
    dict, the device's p and q emitted as they are."""
    with span('hicpeaks.host_complete'):
        cnt, d_idx, x_idx, Ov, ICEv, Foldv, pv, qv = fetched
        n = int(cnt)
        return dict(x=x_idx[:n], y=x_idx[:n] + d_idx[:n], O=Ov[:n],
                    ICE=ICEv[:n], Fold=Foldv[:n], p=pv[:n], q=qv[:n],
                    prod=prod)


def _compact_to_host(fetched, prod, sig, exact=None):
    """One background's row of a fetched ``ops.score.Compacted`` (numpy
    arrays; its ``prod`` is not read) -> host dict of its significant
    pixels (x, y, O, ICE, Fold, p, q, prod), p and q looked up in the BH
    tables of its histogram; ``prod`` is the device handle the postcheck
    reads.  ``exact`` = (ExactCtx, p, kind) recomputes the statistics and
    chunks in float64 and corrects the suspects (a record has them only
    with ``exact``).  None where the corrected table could hide a missed
    pixel: the caller re-scores the background with the dense scorer."""
    with span('hicpeaks.host_complete'):
        n = int(fetched.cnt)
        d_idx, x_idx = fetched.d[:n], fetched.x[:n]
        S, C = np.shape(fetched.hist)
        hist64 = np.asarray(fetched.hist, np.int64)
        sus = fetched.sus
        if exact is None:
            # the device's statistics and chunks; chunk 0 is the trash row
            O64, ice64, fold64 = fetched.O[:n], fetched.ICE[:n], \
                fetched.Fold[:n]
            cid64 = np.asarray(fetched.cid[:n], np.int64)
            valid64 = np.clip(cid64, 0, S - 1) > 0
        else:
            ctx, p_set, kind = exact
            O64, E64, fold64, ice64 = hostexact.exact_stats(
                ctx, d_idx, x_idx, p_set, kind)
            cid64, valid64 = hostexact.chunk_ids64(E64, E64 > 0)
        if sus is not None:
            ns = int(sus.cnt)
            ds, xs = sus.d[:ns], sus.x[:ns]
            # the device folded chunks >= S into overflow row S-1, so the
            # subtraction targets the row the pixel actually occupies
            cid_dev = np.clip(np.asarray(sus.cid[:ns], np.int64), 0, S - 1)
            O_s = np.asarray(sus.O[:ns], np.int64)
            gap_s = np.asarray(sus.gap[:ns], bool)
            O64s, E64s, fold64s, ice64s = hostexact.exact_stats(
                ctx, ds, xs, p_set, kind)
            cid64s, valid64s = hostexact.chunk_ids64(E64s, E64s > 0)
            new = (np.where(valid64s, np.clip(cid64s, 0, S - 1), 0), O_s)
            hist64 = move_suspects(hist64, (cid_dev, O_s), new)
        with span('hicpeaks.qtab64'):
            ptab = ptab64(S, C)
            qtab = chunk_qtab(hist64, ptab)
        oc = np.clip(np.floor(np.asarray(O64, np.float64)).astype(np.int64),
                     0, C - 1)
        p64, q64 = lookup(ptab, qtab, (np.clip(cid64, 0, S - 1), oc), valid64)
        fin = q64 <= sig
        out = dict(x=x_idx[fin], y=x_idx[fin] + d_idx[fin], O=O64[fin],
                   ICE=ice64[fin], Fold=fold64[fin], p=p64[fin], q=q64[fin],
                   prod=prod)
        if sus is None:
            return out
        # audit the device superset against the corrected table
        missed = audit(qtab, hist64, new, np.asarray(sus.thr, np.int64), sig)
        if missed:
            return log_failed_audit(missed)
        p64s, q64s = lookup(ptab, qtab, new, valid64s)
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
