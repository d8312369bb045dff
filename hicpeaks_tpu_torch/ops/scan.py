"""The widening ring scan in PyTorch — the plain twin of the scan kernels.

Port of ``hicpeaks_tpu/ops/scan.py`` (see its header for the ring-sum
algebra).  Every accumulator is a fixed-order float add chain, and this
module keeps JAX's order element for element: line accumulators are left
folds ``Vx_r = (Vx_{r-1} + band[e+r]) + band[e-r]``, rings are
``((A + B) + C) + D`` and pool entries apply Kc, Ke, Qc, Qe per ring, then
the reads.  Bit-exact agreement with the jnp scan and with the CUDA
kernels (``csrc/scan_pass_*.cu``) rests on that order.

The row padding of ``2 * maxww`` zero rows and the zero-filled shifts make
every read outside ``[0, num_p) x [0, Lp)`` a zero, which is the contract
the CUDA kernels implement with zero-filled halo tiles.
"""
from __future__ import annotations

from collections import Counter
from typing import Sequence

import torch

from ..core.poolplan import PoolEntry


def shift2(a, dd, dx):
    """out[i, j] = a[i + dd, j + dx], zero-filled outside bounds."""
    n, m = a.shape
    out = torch.zeros_like(a)
    if abs(dd) >= n or abs(dx) >= m:
        return out
    out[max(-dd, 0):n - max(dd, 0), max(-dx, 0):m - max(dx, 0)] = \
        a[max(dd, 0):n - max(-dd, 0), max(dx, 0):m - max(-dx, 0)]
    return out


class _RingState:
    """Incremental line accumulators for one band tensor; ``kinds``
    restricts the ring flavours ('K' donut, 'Q' lower-left) it serves."""

    def __init__(self, band, kinds=('K', 'Q')):
        self.band = band
        z = torch.zeros_like(band)
        self.Vx, self.Wx, self.Vn, self.Wq = z, z, z, z
        self.need_K = 'K' in kinds
        self.need_Q = 'Q' in kinds
        self.r = 0

    def advance(self):
        r = self.r + 1
        band = self.band
        neg = shift2(band, -r, 0)
        if self.need_K:
            self.Vx = self.Vx + shift2(band, r, 0) + neg
        if self.need_Q:
            self.Vn = self.Vn + neg
        # ring sums use Wx/Wq at r-1 (pre-update)
        if self.need_K:
            self._ringK = (shift2(self.Vx, -r, r) + shift2(self.Vx, r, -r)
                           + shift2(self.Wx, r, 0) + shift2(self.Wx, -r, 0))
        if self.need_Q:
            self._ringQ = shift2(self.Vn, -r, r) + shift2(self.Wq, -r, 0)
        anti = shift2(band, -r, r)
        if self.need_K:
            self.Wx = self.Wx + anti + shift2(band, r, -r)
        if self.need_Q:
            self.Wq = self.Wq + anti
        self.r = r

    def ringK(self):
        return self._ringK

    def ringQ(self):
        return self._ringQ


class _RingProvider:
    """Serves ring sums in pool-plan request order, advancing the line
    accumulators lazily and caching each ring until its last request."""

    def __init__(self, bands: dict, pending):
        kinds = {k: {wh for (_, kk, wh) in pending if kk == k}
                 for k in bands}
        self.states = {k: _RingState(v, kinds[k] or {'K', 'Q'})
                       for k, v in bands.items()}
        self.pending = dict(pending)
        self.cache = {}
        self.r_cur = 0

    def get(self, r, kind, which):
        key = (r, kind, which)
        while self.r_cur < r:
            self.r_cur += 1
            for k, st in self.states.items():
                st.advance()
                for wh, fn in (('K', st.ringK), ('Q', st.ringQ)):
                    ck = (self.r_cur, k, wh)
                    if self.pending.get(ck, 0) > 0:
                        self.cache[ck] = fn()
        if key not in self.cache:
            raise KeyError(f'ring {key} requested but never planned')
        val = self.cache[key]
        self.pending[key] -= 1
        if self.pending[key] == 0:
            del self.cache[key]
        return val


def _ring_mentions(plan: Sequence[PoolEntry], with_captures=True):
    """Request counts of (r, band, which) tuples over the whole plan."""
    c = Counter()
    for e in plan:
        if with_captures:
            for r in e.bg_rings:
                for kind in ('c', 'e'):
                    for wh in ('K', 'Q'):
                        c[(r, kind, wh)] += 1
        for r in e.reads_rings:
            c[(r, 'm', 'Q')] += 1
    return c


def _row_margin(plan):
    """Ring reads reach +-r into accumulators that reach +-r into the band,
    so the scan runs on a domain padded by 2*maxww zero rows per side."""
    return 2 * max(e.w for e in plan)


def _scan_core(raw, cband, eband, cand_mask, plan, p_list, thr, allowed,
               with_captures: bool):
    """Ring-scan math on row-pre-padded arrays.  ``allowed`` is a bool
    tensor [n_entries].  Returns the per-entry counts (int32 [n_entries])
    and, with captures, ``captured`` {p: bool} and ``outs`` {p: [KS, KE,
    YS, YE]}."""
    bands = {'m': raw}
    if with_captures:
        bands['c'] = cband
        bands['e'] = eband
    provider = _RingProvider(bands, _ring_mentions(plan, with_captures))

    zero = torch.zeros(cand_mask.shape, dtype=raw.dtype, device=raw.device)
    accR = zero
    captured = {p: torch.zeros_like(cand_mask) for p in p_list}
    counts = []
    if with_captures:
        accKc = accKe = accQc = accQe = zero
        outs = {p: [zero, zero, zero, zero] for p in p_list}  # KS, KE, YS, YE

    for e in plan:
        if with_captures:
            for r in e.bg_rings:
                accKc = accKc + provider.get(r, 'c', 'K')
                accKe = accKe + provider.get(r, 'e', 'K')
                accQc = accQc + provider.get(r, 'c', 'Q')
                accQe = accQe + provider.get(r, 'e', 'Q')
        for r in e.reads_rings:
            accR = accR + provider.get(r, 'm', 'Q')

        p = e.p
        newly = cand_mask & ~captured[p] & (accR >= thr)
        counts.append(newly.sum(dtype=torch.int32))
        do_cap = newly & allowed[e.index]
        captured[p] = captured[p] | do_cap
        if with_captures:
            vals = (accKc, accKe, accQc, accQe)
            outs[p] = [torch.where(do_cap, v, old)
                       for v, old in zip(vals, outs[p])]

    counts = torch.stack(counts)
    if with_captures:
        return counts, captured, outs
    return counts


def _scan(raw, cband, eband, cand_mask, plan, p_list, thr, allowed,
          with_captures: bool):
    """Shared body of passes A and B: pad rows, scan, crop."""
    M = _row_margin(plan)

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0, M, M))

    out = _scan_core(pad(raw),
                     pad(cband) if with_captures else None,
                     pad(eband) if with_captures else None,
                     pad(cand_mask), plan, p_list, thr, allowed,
                     with_captures)
    if not with_captures:
        return out
    counts, captured, outs = out
    captured = {p: v[M:-M] for p, v in captured.items()}
    outs = {p: [v[M:-M] for v in o] for p, o in outs.items()}
    return counts, captured, outs


def scan_pass_a(raw, cand_mask, plan, p_list, thr):
    """Freeze-count pass: per-entry freshly-frozen pixel counts (int32
    [n_entries]) with every entry allowed."""
    allowed = torch.ones(len(plan), dtype=torch.bool, device=raw.device)
    return _scan(raw, None, None, cand_mask, plan, p_list, thr, allowed,
                 False)


def scan_pass_b(raw, cband, eband, cand_mask, allowed, plan, p_list, thr):
    """Capture pass: (counts, captured, {p: [KS, KE, YS, YE]}), the frozen
    donut 'K' and lower-left 'Y' background sums, gated by ``allowed``."""
    return _scan(raw, cband, eband, cand_mask, plan, p_list, thr, allowed,
                 True)
