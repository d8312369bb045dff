"""The PyTorch ring-scan twin (hicpeaks_tpu_torch/ops/scan.py) against the
JAX scan and the Pallas kernels in interpret mode: bit-exact at float32.

The twin is what the CUDA scan kernels are held against on the card, so
its add order must be JAX's element for element.  The CPU calls go
through the kernel wrappers (ops/cuda_scan.py), which route CPU tensors to
the twin.

A numpy emulation of the CUDA kernels' schedule (zero-filled halo tiles,
accumulator planes advanced one radius at a time, per-pixel ring values
and slots, the radius-order program of ``cuda_scan.plan_meta``) shows here
that the redesign keeps the twin's add order; the card then shows that
the kernels match (tests/test_torch_kernels.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicpeaks_tpu.core import poolplan
from hicpeaks_tpu.ops import scan as jscan
from hicpeaks_tpu.ops.pallas_scan import (scan_pass_a_pallas,
                                          scan_pass_b_pallas)
from hicpeaks_tpu_torch.ops import cuda_scan

from .torch_threads import one_intra_op_thread  # noqa: F401


def _inputs(num_p, Lp, L, d_lo, maxww, seed, density=0.4, lam=6.0):
    rng = np.random.default_rng(seed)
    raw = ((rng.random((num_p, Lp)) < density)
           * rng.poisson(lam, (num_p, Lp))).astype(np.float32)
    cband = (raw * rng.random((num_p, Lp))).astype(np.float32)
    drow = np.arange(num_p)[:, None]
    col = np.arange(Lp)[None, :]
    eband = np.where((col < (L - drow)) & (drow >= d_lo), 1.7, 0.0
                     ).astype(np.float32)
    cand = (raw != 0) & (drow >= d_lo) & (col < (L - drow))
    if maxww is not None:
        cand &= drow <= num_p - maxww - 1
    return raw, cband, eband, cand


CASES = [
    # (num_p, Lp, L, pw, ww, maxww, thr): the two plans of
    # test_pallas_scan.py, then its three adversarial shapes
    (64, 256, 243, [2], [5], 7, 16),
    (64, 256, 243, [1, 2], [3, 5], 7, 8),
    (17, 139, 131, [1, 2], [3, 5], 10, 8),
    (8, 384, 380, [1, 2], [3, 5], 10, 8),
    (96, 128, 97, [1, 2], [3, 5], 10, 8),
]


@pytest.mark.parametrize('num_p,Lp,L,pw,ww,maxww,thr', CASES)
def test_scan_twin_matches_jax_and_pallas(num_p, Lp, L, pw, ww, maxww, thr):
    raw, cband, eband, cand = _inputs(num_p, Lp, L, min(ww),
                                      maxww if num_p == 64 else None,
                                      seed=num_p * 1000 + Lp)
    plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
    p_list = tuple(sorted(set(pw)))
    allowed = np.ones(len(plan), bool)
    allowed[-1] = False                    # exercise the gate
    J = [jnp.asarray(a) for a in (raw, cband, eband, cand)]
    T = [torch.from_numpy(a) for a in (raw, cband, eband, cand)]

    want_a = np.asarray(jscan.scan_pass_a(J[0], J[3], plan, p_list, thr))
    got_a = cuda_scan.scan_pass_a(T[0], T[3], plan, p_list, thr)
    assert got_a.dtype == torch.int32
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(
        got_a.numpy(),
        np.asarray(scan_pass_a_pallas(J[0], J[3], plan, p_list, thr,
                                      interpret=True)))

    _, _, want_b = jscan.scan_pass_b(*J[:4], jnp.asarray(allowed), plan,
                                     p_list, thr)
    pal_b = scan_pass_b_pallas(*J[:4], jnp.asarray(allowed), plan, p_list,
                               thr, interpret=True)
    got_b = cuda_scan.scan_pass_b(*T[:4], torch.from_numpy(allowed), plan,
                                  p_list, thr)
    for p in p_list:
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            g = got_b[p][t].numpy()
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(want_b[p][t]),
                                          err_msg=f'jnp p={p} {name}')
            np.testing.assert_array_equal(g, np.asarray(pal_b[p][t]),
                                          err_msg=f'pallas p={p} {name}')


def test_scan_twin_captured_and_counts_match_jax():
    """Pass B's own counts and captured masks (the twin's full result)."""
    raw, cband, eband, cand = _inputs(40, 200, 190, 3, None, seed=5)
    plan = tuple(poolplan.hiccups_pool_plan([1, 2], [3, 5], 9))
    p_list = (1, 2)
    allowed = np.ones(len(plan), bool)
    allowed[len(plan) // 2:] = False
    from hicpeaks_tpu_torch.ops import scan as tscan
    want = jscan.scan_pass_b(*(jnp.asarray(a) for a in
                               (raw, cband, eband, cand)),
                             jnp.asarray(allowed), plan, p_list, 8)
    got = tscan.scan_pass_b(*(torch.from_numpy(a) for a in
                              (raw, cband, eband, cand)),
                            torch.from_numpy(allowed), plan, p_list, 8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for p in p_list:
        np.testing.assert_array_equal(got[1][p].numpy(),
                                      np.asarray(want[1][p]))


def test_plan_meta_layout():
    """The program the CUDA kernels read replays the plan: per sum, the
    rings in plan order; every capture test after its entry's adds and
    before the next entry's; a ring read from a slot only after its step,
    and the slot filled at that step."""
    plan = tuple(poolplan.hiccups_pool_plan([1, 2], [3, 5], 6))
    p_list = (1, 2)
    prog = cuda_scan.decode(cuda_scan.plan_meta(plan, p_list))
    assert (prog['n_e'], prog['maxw']) == (len(plan), 6)
    assert prog['p_idx'] == [p_list.index(e.p) for e in plan]
    seq = []       # (step, kind, ring or entry) in execution order
    slot_ring = ({}, {})
    for kind, table in ((cuda_scan.OP_BG, prog['bg_slot']),
                        (cuda_scan.OP_RD, prog['rd_slot'])):
        for r, sl in enumerate(table):
            if sl >= 0:
                slot_ring[kind][sl + 1] = r
                assert prog['need'][r] & (1 << kind)
    for step in range(prog['maxw'] + 1):
        for op in prog['ops'][prog['step_off'][step]:
                              prog['step_off'][step + 1]]:
            kind, arg = op & 3, op >> 2
            if kind == cuda_scan.OP_CAP:
                seq.append((step, kind, arg))
                assert prog['cap_step'][arg] == step
                continue
            r = step if arg == 0 else slot_ring[kind][arg]
            assert r <= step and (arg == 0) == (r == step)
            if arg == 0:
                assert prog['need'][r] & (1 << kind)
            seq.append((step, kind, r))
    want = []
    for e in plan:
        want += [(cuda_scan.OP_BG, r) for r in e.bg_rings]
        want += [(cuda_scan.OP_RD, r) for r in e.reads_rings]
        want.append((cuda_scan.OP_CAP, e.index))
    for kind in (cuda_scan.OP_BG, cuda_scan.OP_RD):
        got_k = [(k, v) for _, k, v in seq if k in (kind, cuda_scan.OP_CAP)]
        want_k = [(k, v) for k, v in want if k in (kind, cuda_scan.OP_CAP)]
        assert got_k == want_k
    # the drift re-add of ring 2 by every (1, w >= 6) entry reads a slot
    assert prog['bg_slot'][2] == 0


def _emulate_kernels(raw, cband, eband, cand, allowed, plan, p_list, thr,
                     td, tx):
    """The CUDA scan kernels' schedule in numpy float32, tile by tile:
    returns (pass A counts, pass B {p: [KS, KE, YS, YE]})."""
    prog = cuda_scan.decode(cuda_scan.plan_meta(plan, p_list))
    m, n_e = prog['maxw'], prog['n_e']
    num_p, Lp = raw.shape
    n_p = len(p_list)
    counts = np.zeros(n_e, np.int64)
    out = np.full((n_p, 4, num_p, Lp), np.nan, np.float32)
    f32 = np.float32
    VR, NR = td + 2 * m, td + m

    def tile(band, d0, x0):
        t = np.zeros((td + 4 * m, tx + 2 * m), f32)
        r0, c0 = d0 - 2 * m, x0 - m
        rs, cs = max(r0, 0), max(c0, 0)
        re, ce = min(r0 + t.shape[0], num_p), min(c0 + t.shape[1], Lp)
        t[rs - r0:re - r0, cs - c0:ce - c0] = band[rs:re, cs:ce]
        return t

    for pass_b in (False, True):
        ok = allowed if pass_b else np.ones(n_e, bool)
        rend = max([prog['cap_step'][e] for e in range(n_e) if ok[e]],
                   default=-1)
        for d0 in range(0, num_p, td):
            for x0 in range(0, Lp, tx):
                dd = np.arange(d0, d0 + td)[:, None]
                xx = np.arange(x0, x0 + tx)[None, :]
                valid = (dd < num_p) & (xx < Lp)
                act = np.zeros((td, tx), bool)
                vd, vx_ = min(td, num_p - d0), min(tx, Lp - x0)
                act[:vd, :vx_] = cand[d0:d0 + vd, x0:x0 + vx_]
                cap = np.zeros((td, tx), np.int64)
                if act.any() and rend >= 0:
                    T = {k: tile(b, d0, x0) for k, b in
                         (('m', raw), ('c', cband), ('e', eband))}
                    Vx = {k: np.zeros((VR, tx + 2 * m), f32) for k in 'ce'}
                    Wx = {k: np.zeros((VR, tx), f32) for k in 'ce'}
                    Vn = {k: np.zeros((NR, tx + m), f32) for k in 'cem'}
                    Wq = {k: np.zeros((NR, tx), f32) for k in 'cem'}
                    zero = np.zeros((td, tx), f32)
                    acc = {k: zero for k in ('Kc', 'Ke', 'Qc', 'Qe', 'R')}
                    ring = dict(acc)
                    slots = ({}, {})
                    for r in range(rend + 1):
                        if r > 0:
                            for k in 'ce':
                                Vx[k] = (Vx[k] + T[k][m + r:m + r + VR]) \
                                    + T[k][m - r:m - r + VR]
                            for k in 'cem':
                                Vn[k] = Vn[k] + T[k][m - r:m - r + NR,
                                                     m:m + tx + m]
                            up, dn = slice(m - r, m - r + td), \
                                slice(m + r, m + r + td)
                            for k in 'ce':
                                ring['K' + k] = (
                                    (Vx[k][up, m + r:m + r + tx]
                                     + Vx[k][dn, m - r:m - r + tx])
                                    + Wx[k][dn]) + Wx[k][up]
                            for k, name in (('c', 'Qc'), ('e', 'Qe'),
                                            ('m', 'R')):
                                ring[name] = Vn[k][up, r:r + tx] + Wq[k][up]
                            for k in 'ce':
                                Wx[k] = (Wx[k] + T[k][m - r:m - r + VR,
                                                      m + r:m + r + tx]) \
                                    + T[k][m + r:m + r + VR, m - r:m - r + tx]
                            for k in 'cem':
                                Wq[k] = Wq[k] + T[k][m - r:m - r + NR,
                                                     m + r:m + r + tx]
                            if prog['bg_slot'][r] >= 0:
                                slots[0][prog['bg_slot'][r] + 1] = dict(ring)
                            if prog['rd_slot'][r] >= 0:
                                slots[1][prog['rd_slot'][r] + 1] = dict(ring)
                        for op in prog['ops'][prog['step_off'][r]:
                                              prog['step_off'][r + 1]]:
                            kind, arg = op & 3, op >> 2
                            if kind == cuda_scan.OP_CAP:
                                if not ok[arg]:
                                    continue
                                bit = 1 << prog['p_idx'][arg]
                                newly = act & ((cap & bit) == 0) \
                                    & (acc['R'] >= thr)
                                cap |= np.where(newly, bit, 0)
                                counts[arg] += 0 if pass_b else newly.sum()
                                if pass_b:
                                    pi = prog['p_idx'][arg]
                                    for t, name in enumerate(
                                            ('Kc', 'Ke', 'Qc', 'Qe')):
                                        o = out[pi, t, d0:d0 + vd,
                                                x0:x0 + vx_]
                                        o[newly[:vd, :vx_]] = \
                                            acc[name][:vd, :vx_][
                                                newly[:vd, :vx_]]
                                continue
                            src = ring if arg == 0 else slots[kind][arg]
                            names = ('Kc', 'Ke', 'Qc', 'Qe') \
                                if kind == cuda_scan.OP_BG else ('R',)
                            for name in names:
                                acc[name] = acc[name] + src[name]
                if pass_b:
                    for pi in range(n_p):
                        z = (((cap >> pi) & 1) == 0) & valid
                        for t in range(4):
                            o = out[pi, t, d0:d0 + vd, x0:x0 + vx_]
                            o[z[:vd, :vx_]] = 0.0
    assert not np.isnan(out).any(), 'an output cell was never written'
    return counts, {p: [out[i, t] for t in range(4)]
                    for i, p in enumerate(p_list)}


EMULATION_CASES = [
    # (num_p, Lp, L, plan kind, pw, ww, maxww, thr, tile)
    (40, 70, 66, 'hiccups', [2], [5], 10, 16, (32, 32)),
    (40, 70, 66, 'hiccups', [1, 2], [3, 5], 10, 8, (32, 32)),
    # a high threshold spreads the captures over the entries, so the
    # drift re-adds of ring 2 (read from a slot) reach captured sums
    (40, 70, 66, 'hiccups', [1, 2], [3, 5], 10, 90, (32, 32)),
    (37, 83, 80, 'bhfdr', 2, 5, 10, 16, (32, 32)),
    (21, 45, 40, 'hiccups', [1, 2], [3, 5], 10, 8, (8, 16)),
    (19, 50, 47, 'hiccups', [0], [1], 1, 2, (32, 32)),
    (13, 29, 27, 'bhfdr', 0, 1, 1, 2, (8, 16)),
]


@pytest.mark.parametrize('num_p,Lp,L,kind,pw,ww,maxww,thr,tile',
                         EMULATION_CASES)
def test_kernel_schedule_emulation_matches_twin(num_p, Lp, L, kind, pw, ww,
                                                maxww, thr, tile):
    """Bit-equal to ops/scan.py's passes on ragged shapes, single- and
    multi-pair pyHICCUPS plans and the pyBHFDR plan, maxw 1 and 10, with
    a gate that cuts the last entries."""
    raw, cband, eband, cand = _inputs(num_p, Lp, L, 1, None,
                                      seed=num_p * 31 + Lp)
    if kind == 'hiccups':
        plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
        p_list = tuple(sorted(set(pw)))
    else:
        plan = tuple(poolplan.bhfdr_pool_plan(pw, ww, maxww))
        p_list = (pw,)
    allowed = np.ones(len(plan), bool)
    allowed[(len(plan) + 1) // 2:] = len(plan) == 1
    from hicpeaks_tpu_torch.ops import scan as tscan
    T = [torch.from_numpy(a) for a in (raw, cband, eband, cand)]
    want_a = tscan.scan_pass_a(T[0], T[3], plan, p_list, thr).numpy()
    want_b = tscan.scan_pass_b(*T, torch.from_numpy(allowed), plan, p_list,
                               thr)[2]
    got_a, got_b = _emulate_kernels(raw, cband, eband, cand, allowed, plan,
                                    p_list, thr, *tile)
    assert want_a.sum() > 0
    np.testing.assert_array_equal(got_a, want_a)
    n_cap = 0
    for p in p_list:
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            g, w = got_b[p][t], want_b[p][t].numpy()
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w, err_msg=f'p={p} {name}')
            n_cap += int((w != 0).sum())
    assert n_cap > 0
