"""The port's sheets, freeze gate and scorer (hicpeaks_tpu_torch/ops/
score.py, core/poolplan.py, core/hostcomplete.py) against their JAX
counterparts on the same numpy-seeded inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicpeaks_tpu.core import poolplan as jpoolplan
from hicpeaks_tpu.ops import score as jscore
from hicpeaks_tpu_torch.core import hostcomplete
from hicpeaks_tpu_torch.core import poolplan as tpoolplan
from hicpeaks_tpu_torch.core.engine import _chunk_margin
from hicpeaks_tpu_torch.ops import score as tscore

from .torch_threads import one_intra_op_thread  # noqa: F401


def _vectors(num_p, Lp, L, dtype, seed):
    rng = np.random.default_rng(seed)
    raw = ((rng.random((num_p, Lp)) < 0.5)
           * rng.poisson(4.0, (num_p, Lp))).astype(np.float32)
    w0 = rng.uniform(0.5, 2.0, Lp)
    w0[rng.random(Lp) < 0.05] = 0.0
    w0[L:] = 0.0
    bias = np.where(w0 > 0, 1.0 / np.where(w0 > 0, w0, 1.0), 0.0)
    IR = rng.uniform(0.1, 5.0, num_p)
    gap = rng.random(Lp) < 0.03
    return (raw, w0.astype(dtype), bias.astype(dtype), IR.astype(dtype),
            gap)


@pytest.mark.parametrize('dtype,num_p,Lp,L,gap_s', [
    (np.float32, 48, 256, 240, 3),
    (np.float64, 48, 256, 240, 3),     # f64 vectors: the test session's x64
    (np.float32, 17, 139, 131, 5),
])
def test_sheets_match_jax(dtype, num_p, Lp, L, gap_s):
    raw, w0, bias, IR, gap = _vectors(num_p, Lp, L, dtype, seed=num_p)
    ww_min, d_lo, d_hi = 3, 3, num_p - 4
    want = jscore._build_sheets_jit(
        jnp.asarray(raw), jnp.asarray(w0), jnp.asarray(bias),
        jnp.asarray(IR), jnp.asarray(gap), ww_min=ww_min, L=L, d_lo=d_lo,
        d_hi=d_hi, gap_s=gap_s)
    got = tscore.build_sheets(
        torch.from_numpy(raw), torch.from_numpy(w0), torch.from_numpy(bias),
        torch.from_numpy(IR), torch.from_numpy(gap), ww_min, L, d_lo, d_hi,
        gap_s)
    names = ('raw', 'cband', 'eband', 'Bprod', 'gap_drop', 'cand')
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    # the gap filter also matches the host reference
    np.testing.assert_array_equal(
        got[4].numpy(), jscore.gap_reject_host(gap, num_p, L, gap_s))


@pytest.mark.parametrize('pw,ww,maxww,seed', [
    ((2,), (5,), 10, 0), ((1, 2), (3, 5), 9, 1), ((1, 2, 3), (3, 4, 6), 9, 2)])
def test_freeze_gate_matches_host_replay(pw, ww, maxww, seed):
    """Random counts, many of them truncating: the int32 device gate equals
    emulate_freeze_hiccups, and equals JAX's device gate."""
    plan = tuple(jpoolplan.hiccups_pool_plan(pw, ww, maxww))
    rng = np.random.default_rng(seed)
    n_trunc = 0
    for trial in range(60):
        total = int(rng.integers(0, 5000))
        scale = rng.choice([0.02, 0.1, 0.3, 0.6])
        counts = rng.integers(0, max(1, int(total * scale)) + 1,
                              len(plan)).astype(np.int32)
        t_left = jpoolplan.left_threshold(total)
        want = jpoolplan.emulate_freeze_hiccups(plan, counts, total, ww)
        got = tpoolplan.device_allowed_hiccups(torch.from_numpy(counts),
                                               total, t_left, plan, ww)
        np.testing.assert_array_equal(got.numpy(), want.allowed)
        np.testing.assert_array_equal(
            got.numpy(),
            np.asarray(jpoolplan.device_allowed_hiccups(
                jnp.asarray(counts), total, t_left, plan, ww)))
        n_trunc += not all(want.allowed)
    assert n_trunc > 5          # the cases exercise truncation


def _scored_E(n, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    E = np.exp(rng.uniform(np.log(0.05), np.log(300.0), n)).astype(dtype)
    # exact chunk edges 2^(k/3) and near-edge values
    k = rng.integers(-6, 24, 200)
    E[:200] = np.power(2.0, k / 3.0).astype(dtype)
    E[200:400] = (np.power(2.0, k / 3.0)
                  * (1 + rng.choice([-1, 1], 200) * 3e-7)).astype(dtype)
    scored = rng.random(n) < 0.9
    return E, scored


def test_lambda_chunks_match_jax_outside_suspects():
    """cid/valid agree wherever lambda_suspects does not flag the pixel:
    torch's and XLA's f32 log/pow may differ by an ulp only at chunk
    edges, which the suspects exist for."""
    from hicpeaks_tpu.core import poolplan
    plan = tuple(poolplan.hiccups_pool_plan((2,), (5,), 10))
    margin = _chunk_margin(plan)
    E, scored = _scored_E(50000, seed=3)
    jc, _, jv = jscore.lambda_chunks(jnp.asarray(E), jnp.asarray(scored))
    js = np.asarray(jscore.lambda_suspects(jnp.asarray(E),
                                           jnp.asarray(scored), margin))
    tc, _, tv = tscore.lambda_chunks(torch.from_numpy(E),
                                     torch.from_numpy(scored))
    ts = tscore.lambda_suspects(torch.from_numpy(E), torch.from_numpy(scored),
                                margin).numpy()
    sus = js | ts
    assert sus[:400].sum() > 300          # edge pixels are suspects
    ok = ~sus
    np.testing.assert_array_equal(tc.numpy()[ok], np.asarray(jc)[ok])
    np.testing.assert_array_equal(tv.numpy()[ok], np.asarray(jv)[ok])
    # and on every valid non-suspect pixel the chunk is the float64 one
    from hicpeaks_tpu.ops.hostexact import chunk_ids64
    c64, v64 = chunk_ids64(E.astype(np.float64), scored)
    vv = ok & tv.numpy()
    np.testing.assert_array_equal(tc.numpy()[vv], c64[vv])


def test_compact_mask_batched_matches_jax():
    rng = np.random.default_rng(4)
    keep = rng.random((3, 40, 97)) < np.array([0.05, 0.0, 0.3])[:, None,
                                                                  None]
    cap = 2048
    jc, jd, jx = jscore.compact_mask_batched(jnp.asarray(keep), cap)
    tc, td, tx = tscore.compact_mask_batched(torch.from_numpy(keep))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for b in range(3):
        n = int(tc[b])
        np.testing.assert_array_equal(td[b, :n].numpy(),
                                      np.asarray(jd)[b, :n])
        np.testing.assert_array_equal(tx[b, :n].numpy(),
                                      np.asarray(jx)[b, :n])
        # padding points at the last cell, as JAX's does
        assert (td[b, n:] == 39).all() and (tx[b, n:] == 96).all()


@pytest.mark.parametrize('sig,o_cap', [(0.05, 1024), (0.31, 256),
                                       (0.05, 4096)])
def test_chunk_bh_keep_batched_matches_jax(sig, o_cap):
    """JAX's ``chunk_bh_keep_batched`` against the steps the port's
    batched scorer takes (``engine._compact_batched``: ``chunk_pack``, one
    histogram launch, ``chunk_thresholds``, ``chunk_keep``).  B=2 with the
    same cid/valid given to both: keep, and thr and histogram rows >= 1,
    equal (row 0 is the trash row; JAX's padding lands in its cell (0,
    0)).  At o_cap 4096 (S = 48, the cap of deeper data) a fifth of the
    counts spread log-uniformly over the table."""
    rng = np.random.default_rng(23)
    num_p, Lp, B = 30, 300, 2
    O = rng.poisson(6.0, (num_p, Lp)).astype(np.float32)
    O[rng.random((num_p, Lp)) < 0.002] = o_cap * 2.0     # clip-at-cap
    E = np.exp(rng.uniform(np.log(0.05), np.log(300.0), (B, num_p, Lp))
               ).astype(np.float32)
    scored = rng.random((B, num_p, Lp)) < 0.9
    if o_cap > 1024:
        deep = rng.random((num_p, Lp)) < 0.2
        O[deep] = np.floor(np.exp(rng.uniform(0.0, np.log(o_cap),
                                              int(deep.sum()))))
    cid, _, valid = jscore.lambda_chunks(jnp.asarray(E), jnp.asarray(scored))
    cid, valid = np.array(cid), np.array(valid)
    S = jscore.chunk_rows(o_cap, sig)
    if o_cap == 4096:
        assert S == 48
    Ob = np.broadcast_to(O, (B, num_p, Lp)).copy()
    jk, _, jh, jt, _ = jscore.chunk_bh_keep_batched(
        jnp.asarray(Ob), jnp.asarray(cid), jnp.asarray(valid),
        jnp.float32(sig), B, n_chunks=S, o_cap=o_cap, slack=0.01)
    To, tcid, tvalid = (torch.from_numpy(O), torch.from_numpy(cid),
                        torch.from_numpy(valid))
    C = o_cap + 1
    oc, cid0 = tscore.chunk_pack(To, tcid, tvalid, S, C)
    th = tscore.chunk_hist(oc, cid0, S, C)
    _, tt = tscore.chunk_thresholds(th, B, S, sig, 0.01, To.dtype)
    tk = tscore.chunk_keep(To, tcid, tvalid, tt, sig, C)
    jh = np.asarray(jh).reshape(B, S, -1)
    th = th.numpy().reshape(B, S, -1)
    np.testing.assert_array_equal(th[:, 1:], jh[:, 1:])
    np.testing.assert_array_equal(th[:, 0, 1:], jh[:, 0, 1:])
    # thr of the trash row reads JAX's padding too; no pixel uses it
    np.testing.assert_array_equal(tt.numpy()[:, 1:], np.asarray(jt)[:, 1:])
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.numpy().any()


def test_host_completion_copies_match_jax():
    """The torch-free copy of host_chunk_qtab64, and the host completion's
    (chunk, count) lookup of the device's statistics (``_compact_to_host``
    without float64 statistics): host_chunk_complete's p and q, in order
    (sig 2 keeps every pixel)."""
    rng = np.random.default_rng(8)
    hist = rng.integers(0, 30, (40, 257)) * (rng.random((40, 257)) < 0.3)
    O = rng.integers(0, 300, 500).astype(np.float32)
    cid = rng.integers(0, 40, 500)
    for got, want in zip(hostcomplete.host_chunk_qtab64(hist),
                         jscore.host_chunk_qtab64(hist)):
        np.testing.assert_array_equal(got, want)
    at = np.arange(500, dtype=np.int32)
    got = hostcomplete._compact_to_host(
        tscore.Compacted(500, at * 0, at, O, O, O, cid, hist, None, None),
        None, 2.0)
    np.testing.assert_array_equal(got['x'], at)
    for k, want in zip('pq', jscore.host_chunk_complete(O, cid, hist)):
        assert got[k].dtype == want.dtype
        np.testing.assert_array_equal(got[k], want)
