"""Pool planning: the (p, w) widening schedule, its ring-add events and
the freeze gates.

The host half is the port's copy of ``hicpeaks_tpu/core/poolplan.py``
(``pw_ww_pairs`` .. ``left_threshold``, unchanged); the device half is the
int32 torch twins of its ``device_allowed_hiccups`` and
``device_allowed_bhfdr``.

The reference widens the donut through a pool of (p, w) pairs sorted by
(w, p) (``pw_ww_pairs``, callers.py:15-23), mutating shared background
matrices with an incremental add/subtract scheme (callers.py:143-201).
Analysis of those branches shows the state after any pool entry is exactly
a multiset of *square rings* (cells at radius r = max(|a|,|b|), excluding
the center cross) over the band:

* the first entry adds rings (p0, w0];
* an entry whose w exceeds the previous entry's w adds rings (last_w, w];
* an entry whose p is *smaller* than the previous entry's p re-adds rings
  (p, last_p] — even though they are already present (the reference adds
  them again because they fall outside the new smaller P1 box);
* an entry whose p is *larger* than the previous entry's p is a no-op:
  the would-be subtraction of rings (last_p, p] is skipped because those
  cells sit inside the new P1 box and the accumulation branch
  (callers.py:179) only touches non-P1 cells.

The lower-left (``Y``) background follows the same ring schedule restricted
to quadrant cells, and the raw ``Reads`` matrix (freeze control) only ever
receives fresh annuli at min(pw) entries (callers.py:197-198), so it stays
drift-free: Reads(w) = quadrant rings (p0, w].

These events are what the ring scan (``ops/scan.py`` and the scan
kernels) executes; ``tests/test_torch_hostmods.py`` holds the copies
against the JAX package's plans and freeze replays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import torch


def pw_ww_pairs(pw, ww, maxww):
    """(p, w) pool sorted by (w, p) — callers.py:15-23."""
    pool = []
    for p, w in zip(pw, ww):
        for i in range(w, maxww + 1):
            pool.append((i, p))
    return [(i[1], i[0]) for i in sorted(pool)]


@dataclass(frozen=True)
class PoolEntry:
    index: int
    p: int
    w: int
    bg_rings: Tuple[int, ...]      # rings added to the K/Y background state
    reads_rings: Tuple[int, ...]   # quadrant rings added to the Reads state


def hiccups_pool_plan(pw, ww, maxww) -> List[PoolEntry]:
    pool = pw_ww_pairs(pw, ww, maxww)
    p_min = min(pw)
    entries = []
    last_p = last_w = None
    for idx, (p, w) in enumerate(pool):
        bg: List[int] = []
        reads: List[int] = []
        if last_p is None:
            bg.extend(range(p + 1, w + 1))
            reads.extend(range(p + 1, w + 1))
        else:
            if p < last_p:
                bg.extend(range(p + 1, last_p + 1))   # drift re-add
            if w > last_w:
                bg.extend(range(last_w + 1, w + 1))
                if p == p_min:
                    reads.extend(range(last_w + 1, w + 1))
        entries.append(PoolEntry(idx, p, w, tuple(bg), tuple(reads)))
        last_p, last_w = p, w
    return entries


def bhfdr_pool_plan(pw, ww, maxww) -> List[PoolEntry]:
    """Single-p widening loop (callers.py:440-513): clean annulus growth."""
    entries = []
    for idx, w in enumerate(range(ww, maxww + 1)):
        if idx == 0:
            rings = tuple(range(pw + 1, w + 1))
        else:
            rings = (w,)
        entries.append(PoolEntry(idx, pw, w, rings, rings))
    return entries


@dataclass
class FreezeDecision:
    allowed: List[bool]
    frozen_w: int


def emulate_freeze_hiccups(plan, counts_new, total, ww) -> FreezeDecision:
    """Replay the global early-stop bookkeeping of callers.py:203-232 from
    per-entry freshly-frozen pixel counts (computed device-side without
    truncation — truncation only ever skips a suffix of the pool in w, so
    the counts of allowed entries are unaffected)."""
    max_ww = max(ww)
    frozen_w = max(e.w for e in plan)
    ini = {}
    allowed = []
    for e in plan:
        if e.w > frozen_w:
            allowed.append(False)
            continue
        allowed.append(True)
        ini.setdefault(e.p, total)
        n_new = int(counts_new[e.index])
        valid_ratio = n_new / ini[e.p] if ini[e.p] > 0 else float('nan')
        ini[e.p] -= n_new
        left_ratio = ini[e.p] / total if total > 0 else 0.0
        if (valid_ratio < 0.3) and (e.w >= max_ww):
            frozen_w = e.w
        if (left_ratio < 0.03) and (e.w >= max_ww):
            frozen_w = e.w
    return FreezeDecision(allowed, frozen_w)


def emulate_freeze_bhfdr(plan, counts_new, total) -> FreezeDecision:
    """callers.py:505-511 — plain breaks, no w >= max(ww) gate."""
    allowed = []
    ini = total
    broke = False
    last_w = plan[0].w if plan else 0
    for e in plan:
        if broke:
            allowed.append(False)
            continue
        allowed.append(True)
        last_w = e.w
        n_new = int(counts_new[e.index])
        valid_ratio = n_new / ini if ini > 0 else float('nan')
        ini -= n_new
        left_ratio = ini / total if total > 0 else 0.0
        if valid_ratio < 0.3 or left_ratio < 0.03:
            broke = True
    return FreezeDecision(allowed, last_w)


def left_threshold(total: int) -> int:
    """Exact integer threshold for ``left_ratio < 0.03``: with
    ``ini = total - frozen_so_far``, the reference's float comparison
    ``ini / total < 0.03`` (total > 0) is the rational ``100*ini <
    3*total``, i.e. ``ini <= ceil(3*total/100) - 1``.  Computed on the
    host in exact Python ints so the device emulation (a 32-bit scalar
    compare) reproduces the float64 branch bit-for-bit; ``total == 0``
    makes the ratio 0.0 < 0.03 unconditionally true, encoded as INT32_MAX.

    Exactness: 0.03 has no finite binary expansion, so float64
    ``ini/total < 0.03`` could in principle disagree with the rational
    form when ini/total is within 1 ulp of 0.03.  ``ini/total`` is a
    ratio of ints <= 2^31, and the nearest double to 0.03 is ~8.7e-19
    above 3/100; a rational p/q with q < 2^31 inside that gap would need
    |p/q - 3/100| < 8.7e-19, impossible since |100p - 3q|/(100q) >=
    1/(100*2^31) ~ 4.7e-12 when 100p != 3q (and equality means exact
    3/100, on the correct strict side of both forms)."""
    if total <= 0:
        return (1 << 31) - 1
    return -(-3 * total // 100) - 1


def device_allowed_hiccups(counts_new, total, t_left, plan, ww):
    """Per-entry ``allowed`` gate (bool [n_entries]) from pass A's counts.

    Every comparison is integer-exact: ``valid_ratio < 0.3`` is
    ``10*n_new < 3*prev`` and ``left_ratio < 0.03`` is ``ini <= t_left``
    (``poolplan.left_threshold``), never a float ratio, so the gate equals
    the host replay ``emulate_freeze_hiccups`` on the same counts.  Callers
    ensure ``10*total < 2**31``."""
    dev = counts_new.device
    i32 = dict(dtype=torch.int32, device=dev)
    max_ww = max(ww)
    frozen_w = torch.tensor(max(e.w for e in plan), **i32)
    total = torch.tensor(int(total), **i32)
    t_left = torch.tensor(int(t_left), **i32)
    zero = torch.zeros((), **i32)
    counts_new = counts_new.to(torch.int32)
    ini = {}
    allowed = []
    for e in plan:
        ok = torch.tensor(e.w, **i32) <= frozen_w
        allowed.append(ok)
        prev = ini.get(e.p, total)
        n_new = torch.where(ok, counts_new[e.index], zero)
        # valid_ratio < 0.3 (nan when ini == 0 -> False)
        v_lt = (prev > 0) & (10 * n_new < 3 * prev)
        nxt = prev - n_new
        l_lt = nxt <= t_left
        if e.w >= max_ww:
            frozen_w = torch.where(ok & (v_lt | l_lt),
                                   torch.tensor(e.w, **i32), frozen_w)
        ini[e.p] = torch.where(ok, nxt, prev)
    return torch.stack(allowed)


def device_allowed_bhfdr(counts_new, total, t_left, plan):
    """Per-entry ``allowed`` gate of the pyBHFDR widening loop: a plain
    break after the first entry whose ``valid_ratio < 0.3`` or
    ``left_ratio < 0.03``, with no ``w >= max(ww)`` condition.  The same
    int32 comparisons as :func:`device_allowed_hiccups`, so the gate equals
    ``emulate_freeze_bhfdr`` on the same counts.  Callers ensure
    ``10*total < 2**31``."""
    dev = counts_new.device
    i32 = dict(dtype=torch.int32, device=dev)
    ini = torch.tensor(int(total), **i32)
    t_left = torch.tensor(int(t_left), **i32)
    zero = torch.zeros((), **i32)
    broke = torch.zeros((), dtype=torch.bool, device=dev)
    counts_new = counts_new.to(torch.int32)
    allowed = []
    for e in plan:
        ok = ~broke
        allowed.append(ok)
        n_new = torch.where(ok, counts_new[e.index], zero)
        v_lt = (ini > 0) & (10 * n_new < 3 * ini)
        ini = torch.where(ok, ini - n_new, ini)
        broke = broke | (ok & (v_lt | (ini <= t_left)))
    return torch.stack(allowed)
