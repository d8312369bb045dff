"""The freeze gates on the device: int32 torch twins of
``hicpeaks_tpu.core.poolplan.device_allowed_hiccups`` and
``device_allowed_bhfdr``.

The host functions of the pool plan (``hiccups_pool_plan``,
``bhfdr_pool_plan``, ``emulate_freeze_hiccups``, ``emulate_freeze_bhfdr``,
``left_threshold``) are imported from ``hicpeaks_tpu.core.poolplan`` as
they are.
"""
from __future__ import annotations

import torch


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
