"""The PyTorch ring-scan twin (hicpeaks_tpu_torch/ops/scan.py) against the
JAX scan and the Pallas kernels in interpret mode: bit-exact at float32.

The twin is what the CUDA scan kernels are held against on the card, so
its add order must be JAX's element for element.  The CPU calls go
through the kernel wrappers (ops/cuda_scan.py), which route CPU tensors to
the twin."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicpeaks_tpu.core import poolplan
from hicpeaks_tpu.ops import scan as jscan
from hicpeaks_tpu.ops.pallas_scan import (scan_pass_a_pallas,
                                          scan_pass_b_pallas)
from hicpeaks_tpu_torch.ops import cuda_scan


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
    """The plan array the CUDA kernels read: per-entry p index, then ring
    offsets/lengths into the flat ring list that follows."""
    plan = tuple(poolplan.hiccups_pool_plan([1, 2], [3, 5], 6))
    p_list = (1, 2)
    meta = cuda_scan.plan_meta(plan, p_list)
    n_e = len(plan)
    for e in plan:
        i = e.index
        assert meta[i] == p_list.index(e.p)
        bo, bl = meta[n_e + i], meta[2 * n_e + i]
        ro, rl = meta[3 * n_e + i], meta[4 * n_e + i]
        assert tuple(meta[bo:bo + bl]) == e.bg_rings
        assert tuple(meta[ro:ro + rl]) == e.reads_rings
