"""Ring-scan passes A and B: CUDA kernel wrappers.

Replace ``hicpeaks_tpu/ops/pallas_scan.py::scan_pass_a_pallas`` and
``scan_pass_b_pallas``.  The kernels are ``csrc/scan_pass_a.cu`` and
``csrc/scan_pass_b.cu``; for CPU tensors the wrappers run the plain twins
in :mod:`hicpeaks_tpu_torch.ops.scan`, for CUDA tensors they launch the
kernel or raise.

The pool plan reaches the kernels as a small int32 program
(:func:`plan_meta`) that replays it in radius order: the kernels advance
their shared accumulator planes one radius at a time, and the program
says, for each radius, which of the plan's ring adds and capture tests
run there, and which rings are kept for a later re-add.
"""
from __future__ import annotations

import torch

from . import scan as scan_ops

#: Kernel limits, mirrored in csrc/scan_common.cuh.
MAX_ENTRIES = 128
MAX_P = 32
MAX_BG_SLOTS = 4
MAX_RD_SLOTS = 2
MAX_META = 512
#: Shared memory a block may use on Hopper (cudaDevAttrMaxSharedMemoryPerBlockOptin).
MAX_SMEM = 232448
TILE_D, TILE_X = 32, 32

OP_BG, OP_RD, OP_CAP = 0, 1, 2
_HDR = 4


def plan_meta(plan, p_list):
    """The plan as the kernels' int32 program (layout in
    csrc/scan_common.cuh): ``[n_e, maxw, n_ops, 0]``, then ``p_idx[n_e]``,
    ``cap_step[n_e]``, ``step_off[maxw + 2]``, ``need[maxw + 1]``,
    ``bg_slot[maxw + 1]``, ``rd_slot[maxw + 1]`` and the ops.

    Ring r exists from step r on.  Each of the two sums (background,
    Reads) takes its adds in plan order; an add runs at the step of its
    ring, but never before the previous capture test or the sum's previous
    add.  An add that runs after its ring's step reads the ring from a
    slot that the kernel fills at that step.  An entry's capture test
    runs after its last add.  So every sum sees the plan's adds in the
    plan's order, and every test sees the sums after its entry."""
    maxw = max_ring(plan)
    steps = [[] for _ in range(maxw + 1)]
    need = [0] * (maxw + 1)
    slots = ({}, {})                      # ring -> slot, per sum
    cap_step = []
    s_cap = 0                             # step of the last capture test
    last = [0, 0]                         # step of each sum's last add
    for e in plan:
        e_step = s_cap
        for kind, rings in ((OP_BG, e.bg_rings), (OP_RD, e.reads_rings)):
            for r in rings:
                step = max(r, s_cap, last[kind])
                if step == r:
                    arg = 0
                    need[r] |= 1 << kind
                else:
                    arg = slots[kind].setdefault(r, len(slots[kind])) + 1
                steps[step].append(kind | arg << 2)
                last[kind] = step
                e_step = max(e_step, step)
        steps[e_step].append(OP_CAP | e.index << 2)
        cap_step.append(e_step)
        s_cap = e_step
    bg_slot, rd_slot = [-1] * (maxw + 1), [-1] * (maxw + 1)
    for kind, table in ((OP_BG, bg_slot), (OP_RD, rd_slot)):
        for r, s in slots[kind].items():
            table[r] = s
            need[r] |= 1 << kind
    step_off, ops = [], []
    for s in steps:
        step_off.append(len(ops))
        ops.extend(s)
    step_off.append(len(ops))
    p_idx = [list(p_list).index(e.p) for e in plan]
    return ([len(plan), maxw, len(ops), 0] + p_idx + cap_step + step_off
            + need + bg_slot + rd_slot + ops)


def decode(meta):
    """The fields of a :func:`plan_meta` program, by name."""
    n_e, maxw, n_ops = meta[0], meta[1], meta[2]
    out, o = dict(n_e=n_e, maxw=maxw), _HDR
    for name, n in (('p_idx', n_e), ('cap_step', n_e),
                    ('step_off', maxw + 2), ('need', maxw + 1),
                    ('bg_slot', maxw + 1), ('rd_slot', maxw + 1),
                    ('ops', n_ops)):
        out[name] = list(meta[o:o + n])
        o += n
    return out


def max_ring(plan):
    """The largest ring radius of the plan: the kernels' halo width."""
    return max(max(e.bg_rings + e.reads_rings, default=0) for e in plan)


def smem_bytes(maxw, pass_b):
    """Shared memory of one block (dynamic + static), as the kernels lay
    it out (csrc/scan_common.cuh ``Geom``)."""
    TR, TC = TILE_D + 4 * maxw, TILE_X + 2 * maxw
    VR, NR, NC = TILE_D + 2 * maxw, TILE_D + maxw, TILE_X + maxw
    tile, vx, vn = TR * TC, VR * TC, NR * NC
    wx, wq = VR * TILE_X, NR * TILE_X
    if pass_b:   # raw's tile stops where its Reads planes stop reading
        return 4 * (2 * tile + (TILE_D + 2 * maxw) * TC + 2 * vx + 3 * vn
                    + 2 * wx + 3 * wq) + 4 * MAX_META + MAX_ENTRIES + 4
    return 4 * ((TILE_D + 2 * maxw) * TC + vn + wq) + 4 * MAX_META \
        + 4 * MAX_ENTRIES


def _on_cpu(*ts):
    return all(t.device.type == 'cpu' for t in ts)


def _check(name, plan, p_list, floats, masks, shape, pass_b):
    """Validate the kernel's inputs; raise on anything it does not take.
    Returns the plan's program."""
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
    if min(min(e.bg_rings + e.reads_rings, default=1) for e in plan) < 1 \
            or max_ring(plan) < 1:
        raise ValueError(f'{name}: ring radii must be >= 1')
    meta = plan_meta(plan, p_list)
    prog = decode(meta)
    maxw = prog['maxw']
    n_bg, n_rd = max(prog['bg_slot']) + 1, max(prog['rd_slot']) + 1
    if n_bg > MAX_BG_SLOTS or n_rd > MAX_RD_SLOTS or len(meta) > MAX_META:
        raise ValueError(f'{name}: the plan re-adds {n_bg} background and '
                         f'{n_rd} Reads rings and takes {len(meta)} program '
                         f'words; the kernels keep {MAX_BG_SLOTS}, '
                         f'{MAX_RD_SLOTS} and {MAX_META}')
    if smem_bytes(maxw, pass_b) > MAX_SMEM:
        raise ValueError(f'{name}: maxw={maxw} needs '
                         f'{smem_bytes(maxw, pass_b)} bytes of shared memory '
                         f'per block, above the {MAX_SMEM} a Hopper block '
                         'may use')
    return meta


def scan_pass_a(raw, cand, plan, p_list, thr):
    """Freeze-count pass: int32 [n_entries] freshly-frozen pixel counts.
    ``raw`` float32 and ``cand`` bool, [num_p, Lp]."""
    if _on_cpu(raw, cand):
        return scan_ops.scan_pass_a(raw, cand, plan, p_list, thr)
    meta = _check('scan_pass_a', plan, p_list, [raw], [cand],
                  tuple(raw.shape), pass_b=False)
    from ..kernels.build import check, load
    lib = load()
    num_p, Lp = raw.shape
    meta_d = torch.tensor(meta, dtype=torch.int32, device=raw.device)
    counts = torch.zeros(len(plan), dtype=torch.int32, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_scan_pass_a(
            raw.data_ptr(), cand.data_ptr(), num_p, Lp, meta_d.data_ptr(),
            len(meta), len(plan), max_ring(plan), float(thr),
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
    meta = _check('scan_pass_b', plan, p_list, [raw, cband, eband],
                  [cand, allowed], shape, pass_b=True)
    if allowed.dtype != torch.bool or tuple(allowed.shape) != (len(plan),):
        raise TypeError(f'scan_pass_b: bool [{len(plan)}] allowed gate '
                        f'required, got {allowed.dtype} '
                        f'{tuple(allowed.shape)}')
    from ..kernels.build import check, load
    lib = load()
    num_p, Lp = shape
    n_p = len(p_list)
    meta_d = torch.tensor(meta, dtype=torch.int32, device=raw.device)
    # the kernel writes every cell: captured sums, or 0
    out = torch.empty((n_p, 4, num_p, Lp), dtype=torch.float32,
                      device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_scan_pass_b(
            raw.data_ptr(), cband.data_ptr(), eband.data_ptr(),
            cand.data_ptr(), allowed.data_ptr(), num_p, Lp, meta_d.data_ptr(),
            len(meta), len(plan), n_p, max_ring(plan), float(thr),
            out.data_ptr(), stream)
    check(err, 'scan_pass_b')
    scan_pass_b.launches += 1
    return {p: [out[i, t] for t in range(4)] for i, p in enumerate(p_list)}


scan_pass_a.launches = 0
scan_pass_b.launches = 0
