"""Ring-scan passes A and B: CUDA kernel wrappers.

Replace ``hicpeaks_tpu/ops/pallas_scan.py::scan_pass_a_pallas`` and
``scan_pass_b_pallas``.  The kernels are ``csrc/scan_pass_a.cu`` and
``csrc/scan_pass_b.cu``; for CPU tensors the wrappers run the plain twins
in :mod:`hicpeaks_tpu_torch.ops.scan`, for CUDA tensors they launch the
kernel or raise.

The pool plan reaches the kernels as one small int32 device array
(:func:`plan_meta`): per entry its p index, then the offset and length of
its ``bg_rings`` and ``reads_rings`` in a flat ring list that follows.
"""
from __future__ import annotations

import torch

from . import scan as scan_ops

#: Kernel limits, mirrored in csrc/scan_common.cuh.
MAX_ENTRIES = 128
MAX_P = 32


def plan_meta(plan, p_list):
    """The plan as a flat int32 list: [p_idx | bg_off | bg_len | rd_off |
    rd_len] (n_e each), then the rings; offsets index the whole list."""
    n_e = len(plan)
    rings = []
    bg_off, bg_len, rd_off, rd_len = [], [], [], []
    base = 5 * n_e
    for e in plan:
        bg_off.append(base + len(rings))
        bg_len.append(len(e.bg_rings))
        rings.extend(e.bg_rings)
        rd_off.append(base + len(rings))
        rd_len.append(len(e.reads_rings))
        rings.extend(e.reads_rings)
    p_idx = [list(p_list).index(e.p) for e in plan]
    return p_idx + bg_off + bg_len + rd_off + rd_len + list(rings)


def _max_ring(plan):
    """The largest ring radius of the plan: the kernels' halo width."""
    return max(max(e.bg_rings + e.reads_rings, default=0) for e in plan)


def _on_cpu(*ts):
    return all(t.device.type == 'cpu' for t in ts)


def _check(name, plan, p_list, floats, masks, shape):
    """Validate the kernel's inputs; raise on anything it does not take."""
    dev = floats[0].device
    for t in floats + masks:
        if t.device != dev or dev.type != 'cuda':
            raise ValueError(f'{name}: all inputs must be on one CUDA device '
                             f'(or all on the CPU), got {t.device}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: inputs must be contiguous')
    for t in floats:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise TypeError(f'{name}: float32 {shape} sheets required, got '
                            f'{t.dtype} {tuple(t.shape)}')
    if masks[0].dtype != torch.bool or tuple(masks[0].shape) != shape:
        raise TypeError(f'{name}: bool {shape} candidate mask required')
    if len(shape) != 2 or shape[0] < 1 or shape[1] < 1:
        raise ValueError(f'{name}: 2-D non-empty band required, got {shape}')
    if not plan or len(plan) > MAX_ENTRIES or len(p_list) > MAX_P:
        raise ValueError(f'{name}: plan of {len(plan)} entries and '
                         f'{len(p_list)} p values exceeds the kernel limits '
                         f'({MAX_ENTRIES}, {MAX_P})')
    if min(min(e.bg_rings + e.reads_rings, default=1) for e in plan) < 1:
        raise ValueError(f'{name}: ring radii must be >= 1')


def scan_pass_a(raw, cand, plan, p_list, thr):
    """Freeze-count pass: int32 [n_entries] freshly-frozen pixel counts.
    ``raw`` float32 and ``cand`` bool, [num_p, Lp]."""
    if _on_cpu(raw, cand):
        return scan_ops.scan_pass_a(raw, cand, plan, p_list, thr)
    _check('scan_pass_a', plan, p_list, [raw], [cand], tuple(raw.shape))
    from ..kernels.build import check, load
    lib = load()
    num_p, Lp = raw.shape
    meta = torch.tensor(plan_meta(plan, p_list), dtype=torch.int32,
                        device=raw.device)
    counts = torch.zeros(len(plan), dtype=torch.int32, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_scan_pass_a(
            raw.data_ptr(), cand.data_ptr(), num_p, Lp, meta.data_ptr(),
            len(plan), _max_ring(plan), float(thr),
            counts.data_ptr(), stream)
    check(err, 'scan_pass_a')
    scan_pass_a.launches += 1
    return counts


def scan_pass_b(raw, cband, eband, cand, allowed, plan, p_list, thr):
    """Capture pass: {p: [KS, KE, YS, YE]} float32 [num_p, Lp] frozen
    background sums, gated by the bool [n_entries] ``allowed``."""
    if _on_cpu(raw, cband, eband, cand, allowed):
        return scan_ops.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                    p_list, thr)[2]
    shape = tuple(raw.shape)
    _check('scan_pass_b', plan, p_list, [raw, cband, eband],
           [cand, allowed], shape)
    if allowed.dtype != torch.bool or tuple(allowed.shape) != (len(plan),):
        raise TypeError(f'scan_pass_b: bool [{len(plan)}] allowed gate '
                        f'required, got {allowed.dtype} '
                        f'{tuple(allowed.shape)}')
    from ..kernels.build import check, load
    lib = load()
    num_p, Lp = shape
    n_p = len(p_list)
    meta = torch.tensor(plan_meta(plan, p_list), dtype=torch.int32,
                        device=raw.device)
    out = torch.zeros((n_p, 4, num_p, Lp), dtype=torch.float32,
                      device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_scan_pass_b(
            raw.data_ptr(), cband.data_ptr(), eband.data_ptr(),
            cand.data_ptr(), allowed.data_ptr(), num_p, Lp, meta.data_ptr(),
            len(plan), n_p, _max_ring(plan), float(thr),
            out.data_ptr(), stream)
    check(err, 'scan_pass_b')
    scan_pass_b.launches += 1
    return {p: [out[i, t] for t in range(4)] for i, p in enumerate(p_list)}


scan_pass_a.launches = 0
scan_pass_b.launches = 0
