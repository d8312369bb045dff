"""pyHICCUPS's float64 completion on the device (core/complete64.py, the
kernel of csrc/complete64.cu through ops/cuda_complete.py) against the
host completion (core/hostcomplete._compact_to_host) it replaces on the
batched route.

On the CPU the kernel's wrapper runs its twin, the host's float64
statistics, so these tests hold the device route's orchestration (the
suspects' histogram moves, the BH tables from the kept p table, the
lookups, the audit, the compaction and the two reads) to the host
route's dicts: same keys, dtypes, values and order.  The tests marked
``cuda`` hold the kernel to its twin bit for bit on the card
(``python -m pytest --noconftest tests/test_torch_complete64.py``).
Only the port is imported (no JAX)."""
import types

import numpy as np
import pytest
import torch

from hicpeaks_tpu_torch.core import complete64, engine, hostcomplete
from hicpeaks_tpu_torch.core import poolplan
from hicpeaks_tpu_torch.core.config import HiccupsConfig
from hicpeaks_tpu_torch.io.synth import synthesize_chrom
from hicpeaks_tpu_torch.ops import cuda_complete, hostexact, score
from hicpeaks_tpu_torch.ops.band import build_bands

from .torch_threads import one_intra_op_thread  # noqa: F401

CONFIGS = [((1,), (3,), 8), ((1, 2), (3, 5), 8)]
RES = 25000


def _bands(n_bins, seed, dtype, num=88, ww_min=3, **kw):
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=n_bins, res=RES,
                                           seed=seed, **kw)
    w = np.full(n_bins, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    return build_bands(b1, b2, ct, w, n_bins, num, ww_min, RES, chrom='21',
                       dtype=dtype)


def _same(got, want):
    """Two completions' host dicts are the same: None alike, or the same
    keys in order, and arrays of one dtype equal bit for bit."""
    assert (got is None) == (want is None)
    if got is None:
        return
    assert list(got) == list(want)
    for k in want:
        if k == 'prod':
            assert got[k][0] is want[k][0] and got[k][1] == want[k][1]
            continue
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


def _host_route(out, bgs, ctx, sig):
    """The host completion of the batched record ``out``, as the engine
    made it before the device route."""
    fetched = engine._to_host(out._replace(prod=None))
    return [hostcomplete._compact_to_host(
        score.one_background(fetched, b), (out.prod, b), sig,
        exact=(ctx, p, kind))
        for b, (p, _, kind, _) in enumerate(bgs)]


def _compared(monkeypatch):
    """Run every device completion of the engine beside the host route on
    the same bundle, assert they agree, and count the backgrounds and
    suspects they completed."""
    seen = {'calls': 0, 'suspects': 0, 'rows': 0}
    real = engine.complete_on_device

    def both(sh, out, bgs, ctx, sig):
        want = _host_route(out, bgs, ctx, sig)
        got = real(sh, out, bgs, ctx, sig)
        assert len(got) == len(want) == len(bgs)
        for g, w in zip(got, want):
            _same(g, w)
        seen['calls'] += 1
        seen['suspects'] += int(out.sus.cnt.sum())
        seen['rows'] += sum(len(g['x']) for g in got if g is not None)
        return got
    monkeypatch.setattr(engine, 'complete_on_device', both)
    return seen


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('pw,ww,maxww', CONFIGS)
def test_device_route_dicts_equal_the_host_routes(pw, ww, maxww, dtype,
                                                  monkeypatch):
    """The fused route's device completion gives the host completion's
    dicts, suspects and every background included, and so its table."""
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, maxapart=2_000_000,
                        min_marginal_peaks=2, min_local_reads=16)
    seen = _compared(monkeypatch)
    bands = _bands(260, 11, dtype, num=2_000_000 // RES + maxww + 1,
                   ww_min=min(ww), n_loops=30, depth=60.0)
    got = engine.hiccups_chrom(bands, cfg, device='cpu')
    assert seen['calls'] == 1 and seen['rows'] > 0 and seen['suspects'] > 0
    _on_the_host(monkeypatch)
    assert engine.hiccups_chrom(bands, cfg, device='cpu') == got


def _on_the_host(monkeypatch):
    """The engine's float64 completion of the batched scorer done by the
    host route in place of the device one."""
    monkeypatch.setattr(engine, 'complete_on_device',
                        lambda sh, out, bgs, ctx, sig:
                        _host_route(out, bgs, ctx, sig))


# ---- the suspect cases of tests/test_suspect_correction.py, through both
# completions, with a stand-in for the float64 statistics


def _bh_bruteforce(cids, counts, sig):
    """Exact per-chunk BH over explicit (chunk, count) pixel lists."""
    from scipy.stats import poisson
    cids, counts = np.asarray(cids), np.asarray(counts)
    q = np.ones(len(cids))
    for s in np.unique(cids):
        m = cids == s
        p = 1.0 - poisson.cdf(counts[m], 2.0 ** ((s - 1.0) / 3.0))
        order = np.argsort(p, kind='stable')
        ranks = np.empty(len(p))
        ranks[order] = np.arange(1, len(p) + 1)
        for pv in np.unique(p):
            ranks[p == pv] = ranks[p == pv].max()
        raw = np.minimum(p * m.sum() / ranks, 1.0)
        out = np.empty(len(p))
        out[order] = np.minimum.accumulate(raw[order][::-1])[::-1]
        q[m] = out
    return q


class _FakeCtx:
    """Stands in for hostexact.ExactCtx: (d, x) -> (E64, count)."""

    def __init__(self, by_coord):
        self.by_coord = by_coord


def _patch_exact(monkeypatch):
    def fake_exact_stats(ctx, d_idx, x_idx, p, kind):
        pairs = [ctx.by_coord[(int(d), int(x))]
                 for d, x in zip(d_idx, x_idx)]
        E64 = np.array([e for e, _ in pairs], np.float64)
        O64 = np.array([c for _, c in pairs], np.float64)
        return O64, E64, O64 / np.maximum(E64, 1e-300), O64 * 0.5
    monkeypatch.setattr(hostexact, 'exact_stats', fake_exact_stats)


def _hist(S, C, cids, counts):
    hist = np.zeros((S, C), np.int32)
    np.add.at(hist, (np.asarray(cids), np.asarray(counts)), 1)
    return hist


def _both(kept, sus, hist, ctx, sig):
    """One 'K' background's bundle through both completions: kept = (n,
    d, x) with d, x of the slots, sus = (n, d, x, device cid, count, gap,
    thr)."""
    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a))[None].to(dtype)
    n, d, x = kept
    O = np.zeros(len(d), np.float32)
    ns, ds, xs, cid_s, O_s, gap_s, thr = sus
    out = score.Compacted(
        t(n), t(d), t(x), O=t(O, torch.float32), ICE=t(O, torch.float32),
        Fold=t(O, torch.float32), cid=t(np.zeros(len(d))), hist=t(hist),
        prod=torch.zeros(1, 2, 2),
        sus=score.Suspects(t(ns), t(ds), t(xs), cid=t(cid_s), O=t(O_s),
                           gap=t(gap_s, torch.bool), thr=t(thr)))
    bgs = [(1, 5, 'K', 0)]
    sh = types.SimpleNamespace(raw=torch.zeros(2, 2))
    want = _host_route(out, bgs, ctx, sig)[0]
    got = complete64.complete_on_device(sh, out, bgs, ctx, sig)[0]
    _same(got, want)
    return got


def test_flipped_suspect(monkeypatch):
    """A suspect whose float64 chunk differs from its device one moves to
    it: q is the brute-force BH over the true assignment."""
    _patch_exact(monkeypatch)
    S, C, sig = 8, 32, 0.05
    base_cids = [4] * 3 + [4] * 40 + [5] * 2 + [5] * 30
    base_cnts = [9] * 3 + [2] * 40 + [12] * 2 + [3] * 30
    hist = _hist(S, C, base_cids + [4], base_cnts + [9])
    q_true = _bh_bruteforce(base_cids + [5], base_cnts + [9], sig)
    E4, E5 = 2.0 ** (2.5 / 3.0), 2.0 ** (3.5 / 3.0)
    d, x = np.zeros(8, np.int32), np.zeros(8, np.int32)
    d[0], x[0] = 3, 10
    thr = np.full(S, C, np.int32)
    thr[4], thr[5] = 9, 12
    sus = (1, np.full(8, 2), np.full(8, 20), np.full(8, 4), np.full(8, 9),
           np.zeros(8, bool), thr)
    r = _both((1, d, x), sus, hist,
              _FakeCtx({(3, 10): (E4, 9), (2, 20): (E5, 9)}), sig)
    got = {(int(a), int(b)): q for a, b, q in zip(r['x'], r['y'], r['q'])}
    q4 = q_true[[c == 4 and n == 9 for c, n in zip(base_cids + [5],
                                                  base_cnts + [9])]]
    assert (q4[0] <= sig) == ((10, 13) in got)
    if q4[0] <= sig:
        np.testing.assert_allclose(got[(10, 13)], q4[0], rtol=1e-12)
    assert (q_true[-1] <= sig) == ((20, 22) in got)
    if q_true[-1] <= sig:
        np.testing.assert_allclose(got[(20, 22)], q_true[-1], rtol=1e-12)


def test_audit_catches_missed_pixel(monkeypatch):
    """A cell significant below the device's count threshold that holds
    non-suspect pixels: the background goes to the dense scorer."""
    _patch_exact(monkeypatch)
    S, C = 8, 32
    thr = np.full(S, C, np.int32)
    thr[4] = 10
    sus = (0,) + tuple(np.zeros(8, np.int32) for _ in range(4)) \
        + (np.zeros(8, bool), thr)
    assert _both((0, np.zeros(8), np.zeros(8)), sus,
                 _hist(S, C, [4] * 3, [9] * 3), _FakeCtx({}), 0.05) is None


@pytest.mark.parametrize('seed', [0, 1])
def test_no_flip_correction_is_identity(monkeypatch, seed):
    """A suspect whose float64 chunk is its device one keeps its q."""
    _patch_exact(monkeypatch)
    rng = np.random.default_rng(seed)
    S, C, sig, n = 10, 64, 0.05, 500
    cids, cnts = rng.integers(1, S, n), rng.integers(0, C, n)
    q_true = _bh_bruteforce(cids, cnts, sig)
    i = int(rng.integers(n))
    sus = (1, np.full(8, 1), np.full(8, 5), np.full(8, cids[i]),
           np.full(8, cnts[i]), np.zeros(8, bool), np.zeros(S, np.int32))
    r = _both((0, np.zeros(8), np.zeros(8)), sus, _hist(S, C, cids, cnts),
              _FakeCtx({(1, 5): (2.0 ** ((cids[i] - 1.5) / 3.0),
                                 cnts[i])}), sig)
    assert r is not None
    assert (q_true[i] <= sig) == (len(r['q']) == 1)
    if q_true[i] <= sig:
        np.testing.assert_allclose(r['q'][0], q_true[i], rtol=1e-12)


# ---- the chunk edges and the kept p table


def _edge_points():
    """Every finite chunk edge, one ulp below and above it, and E's
    special values."""
    edges = cuda_complete.chunk_edges64()
    fin = edges[np.isfinite(edges)]
    pts = np.concatenate([fin, np.nextafter(fin, -np.inf),
                          np.nextafter(fin, np.inf),
                          [0.0, -1.0, 5e-324, 1e-300, 0.5, np.inf, np.nan,
                           np.finfo(np.float64).max]])
    return pts


def _chunks_by_edges(E, S):
    """The kernel's rule: the edges below E, one chunk more, 0 on an edge
    or for E not above 0, clipped to S - 1."""
    edges = cuda_complete.chunk_edges64()
    below = np.searchsorted(edges, E, side='left')
    on = (below < edges.size) & (edges[np.minimum(below, edges.size - 1)]
                                 == E)
    return np.where((E > 0) & ~on, np.minimum(1 + below, S - 1), 0)


def _chunks_host(E, S):
    cid, valid = hostexact.chunk_ids64(E, E > 0)
    return np.where(valid, np.clip(cid, 0, S - 1), 0)


@pytest.mark.parametrize('S', [40, 128, 4000])
def test_edge_rule_is_chunk_ids64_at_every_edge(S):
    """At each chunk edge and one ulp either side, the edge table's rule
    gives hostexact.chunk_ids64's chunk, clipped as the completion clips
    it."""
    E = _edge_points()
    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        np.testing.assert_array_equal(_chunks_by_edges(E, S),
                                      _chunks_host(E, S))


def _table_shapes():
    """Every (S, C) that engine._bh_plan and score.chunk_rows give."""
    shapes = set()
    for k in range(10, 18):
        o_cap = engine._bh_plan(1 << k)
        assert o_cap == 1 << k
        for sig in (0.05, 0.5):
            shapes.add((score.chunk_rows(o_cap, sig), o_cap + 1))
    return sorted(shapes)


def test_kept_p_table_is_scipys():
    """The kept (S, C) table equals a fresh scipy table bit for bit for
    every shape the planner gives, and is made once a shape."""
    from scipy.stats import poisson
    shapes = _table_shapes()
    S_max, C_max = max(s for s, _ in shapes), max(c for _, c in shapes)
    assert (S_max, C_max) == (128, (1 << 17) + 1)
    # scipy's cdf is elementwise: the fresh table of the largest shape
    # holds every smaller shape's fresh table as its corner
    rv = np.power(2.0, (np.arange(S_max, dtype=np.float64) - 1.0)
                  / 3.0)[:, None]
    fresh = 1.0 - poisson.cdf(np.arange(C_max, dtype=np.float64)[None, :],
                              rv)
    hostcomplete.ptab64.cache_clear()
    for S, C in shapes:
        kept = hostcomplete.ptab64(S, C)
        assert kept.shape == (S, C) and not kept.flags.writeable
        assert kept.tobytes() == np.ascontiguousarray(
            fresh[:S, :C]).tobytes(), (S, C)
        assert hostcomplete.ptab64(S, C) is kept
    hostcomplete.ptab64.cache_clear()


# ---- on the card


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


def _chr1_sized(seed):
    """A synthetic band of hg38 chr1's shape at 10 kb and a 10 Mb band
    (1016 x 24,960), with float64 vectors, as ExactCtx reads them."""
    rng = np.random.default_rng(seed)
    num_p, Lp, L, ww_min = 1016, 24960, 24896, 5
    dd = np.arange(num_p)[:, None]
    lam = 46.0 * (1.0 + dd) ** -1.08 * np.ones((1, Lp))
    raw = rng.poisson(lam).astype(np.float32)
    raw[np.arange(Lp)[None, :] >= L - dd] = 0
    w = rng.uniform(0.5, 1.5, Lp)
    w[rng.random(Lp) < 0.02] = 0.0
    bias = np.where(w > 0, 1.0 / np.where(w > 0, w, 1.0), 0.0)
    ir = 46.0 * (1.0 + np.arange(num_p)) ** -1.08
    return types.SimpleNamespace(raw=raw, w064=w, bias64=bias, IR64=ir,
                                 L=L, ww_min=ww_min)


def _pixels(rng, B, K, n, num_p, L):
    """int32 [B, K] (d, x) slots: n per background, in band, edges too."""
    # most pixels near the diagonal, where the freeze captures them
    d = np.where(rng.random((B, K)) < 0.7, rng.integers(0, 40, (B, K)),
                 rng.integers(0, num_p, (B, K)))
    x = (rng.random((B, K)) * (L - d)).astype(np.int64)
    d[:, :4], x[:, :4] = [[0, 3, num_p - 1, num_p - 2]], [[0, L - 4, 0, 1]]
    cnt = np.asarray(n, np.int32)
    return cnt, d.astype(np.int32), x.astype(np.int32)


def _card_inputs(pw, ww):
    """A chr1-sized band, its float64 context and kept and suspect slots of
    every background, with their device counts and chunks."""
    rng = np.random.default_rng(len(pw))
    bands = _chr1_sized(len(pw))
    plan = tuple(poolplan.hiccups_pool_plan(list(pw), list(ww), 10))
    allowed = rng.random(len(plan)) < 0.8
    allowed[:2] = True
    ctx = hostexact.ExactCtx(bands, plan, allowed, 16)
    bgs = [(p, k) for k in ('K', 'Y') for p in pw]
    B = len(bgs)
    num_p, L = bands.raw.shape[0], bands.L
    kept = _pixels(rng, B, 20000, [20000, 19000, 0, 7, 15000, 3][:B],
                   num_p, L)
    sus = _pixels(rng, B, 300, [300, 1, 250, 0, 120, 300][:B], num_p, L)
    S, C = 40, 1025
    O_s = np.clip(bands.raw[sus[1], sus[2]], 0, C - 1).astype(np.int32)
    cid_s = rng.integers(0, S, (B, 300)).astype(np.int32)
    return ctx, bgs, kept, sus, O_s, cid_s, S, C


def _record(dev, kept, sus, O_s, hist, cid=None, gap=None, thr=None):
    """The ``Compacted`` on ``dev`` of numpy kept and suspect (count, d,
    x) slots, the suspects' device counts ``O_s`` and an int32 [B, S, C]
    histogram: the fields the completion's kernels read, with the
    suspects' chunks, gap flags and thresholds where given."""
    def t(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(dev)
    return score.Compacted(
        *map(t, kept), O=None, ICE=None, Fold=None, cid=None, hist=t(hist),
        prod=None, sus=score.Suspects(*map(t, sus), cid=t(cid), O=t(O_s),
                                      gap=t(gap), thr=t(thr)))


@pytest.mark.cuda
@pytest.mark.parametrize('pw,ww', [((2,), (5,)), ((1, 2), (3, 5)),
                                   ((1, 2, 4), (3, 5, 7))])
def test_kernels_equal_twins_on_a_chr1_sized_band(device, pw, ww):
    """window_stats64's O, E, Fold, ICE and cells, then finish64's rows,
    kept flags, counts and audit, equal their twins' (the host's native
    walk and numpy; the host completion's table steps) bit for bit, dead slots
    included: at B = 2, 4 and 6 backgrounds, the last the upstream
    QuickStart's three pairs (windows 3, 5 and 7)."""
    ctx, bgs, kept, sus, O_s, cid_s, S, C = _card_inputs(pw, ww)
    assert cuda_complete.walks_natively(ctx)
    raw = torch.from_numpy(ctx.bands.raw)

    # a histogram holding every live slot at its device cell, thresholds
    # low enough that some cells keep pixels and some audits trip
    rng = np.random.default_rng(7)
    B = len(bgs)
    hist = rng.poisson(3.0, (B, S, C)).astype(np.int32)
    np.add.at(hist, (np.arange(B)[:, None].repeat(300, 1), cid_s, O_s), 1)
    thr = rng.integers(0, 30, (B, S)).astype(np.int32)
    gap = rng.random((B, 300)) < 0.1
    ptab = torch.from_numpy(np.array(hostcomplete.ptab64(S, C)))
    rec_h, rec_d = (_record(dev, kept, sus, O_s, hist, cid_s, gap, thr)
                    for dev in ('cpu', device))

    want = cuda_complete.window_stats64(raw, ctx, bgs, rec_h)
    got = cuda_complete.window_stats64(raw.to(device), ctx, bgs, rec_d)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu().view(torch.int64),
                       want[0].view(torch.int64))
    assert torch.equal(got[1].cpu(), want[1])
    assert (want[1] >= C).sum() > 10000

    rows_w, fin_w, head_w = cuda_complete.finish64(rec_h, want[1], want[0],
                                                   ptab, 0.05)
    rows_g, fin_g, head_g = cuda_complete.finish64(rec_d, got[1], got[0],
                                                   ptab.to(device), 0.05)
    torch.cuda.synchronize()
    assert torch.equal(fin_g.cpu(), fin_w) and torch.equal(head_g.cpu(),
                                                           head_w)
    assert torch.equal(rows_g.cpu()[fin_w].view(torch.int64),
                       rows_w[fin_w].view(torch.int64))
    assert fin_w.sum() > 0 and (head_w[1] > 0).any()


def _edge_inputs():
    """A band whose pixels' E are the chunk edges, one ulp either side and
    a few special values: every in-extent count and every weight 1 and
    IR 1 make each ring's balanced sum its expected sum, so the ratio is
    1 and E = bias[x] * bias[x + d], with bias[x] the point and bias[x +
    d] 1 (pixels at d = 3, x even).  The gate reads no threshold, so each
    pixel is captured at its p's first entry."""
    E = _edge_points()
    E = E[np.isfinite(E)]
    n, num_p, d = E.size, 8, 3
    Lp = 2 * n + 8
    bias = np.ones(Lp)
    bias[0:2 * n:2] = E
    raw = (np.arange(Lp)[None, :] < Lp - np.arange(num_p)[:, None])
    bands = types.SimpleNamespace(
        raw=raw.astype(np.float32), w064=np.ones(Lp), bias64=bias,
        IR64=np.ones(num_p), L=Lp, ww_min=0)
    plan = tuple(poolplan.hiccups_pool_plan([1], [3], 3))
    ctx = hostexact.ExactCtx(bands, plan, np.ones(len(plan), bool), 0)
    x = np.arange(0, 2 * n, 2, dtype=np.int32)[None].repeat(2, 0)
    kept = (np.array([n, n], np.int32), np.full_like(x, d), x)
    sus = tuple(a[:, :4].copy() for a in kept[1:])
    sus = (np.array([4, 4], np.int32),) + sus
    return ctx, [(1, 'K'), (1, 'Y')], E, kept, sus


@pytest.mark.cuda
@pytest.mark.parametrize('S', [40, 4000])
def test_kernel_chunks_at_every_edge(device, S):
    """Pixels whose E is each chunk edge or one ulp either side get the
    twin's (chunk, count) cells from window_stats64 (hostexact.chunk_ids64
    clipped to S - 1), and their E is the point itself."""
    ctx, bgs, E, kept, sus = _edge_inputs()
    O_s = np.ones((2, 4), np.int32)

    def run(dev):
        return cuda_complete.window_stats64(
            torch.from_numpy(ctx.bands.raw).to(dev), ctx, bgs,
            _record(dev, kept, sus, O_s, np.zeros((2, S, 2), np.int32)))
    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        want = run('cpu')
    got = run(device)
    torch.cuda.synchronize()
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int64),
                       want[0].view(torch.int64))
    assert np.array_equal(want[0][1, :, :E.size].numpy(), E[None].repeat(2, 0))
    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        chunks = _chunks_host(E, S)
    assert np.array_equal(want[1][:, :E.size].numpy() // 2,
                          chunks[None].repeat(2, 0))


@pytest.mark.cuda
def test_card_raises_where_the_native_walk_does_not_serve(device):
    """A host band the native walk does not take (here a float64 slab) is
    refused on the card, not completed another way."""
    ctx, bgs, _, kept, sus = _edge_inputs()
    raw = torch.from_numpy(ctx.bands.raw).to(device)
    ctx.bands.raw = ctx.bands.raw.astype(np.float64)
    with pytest.raises(ValueError, match='native walk'):
        cuda_complete.window_stats64(
            raw, ctx, bgs,
            _record(device, kept, sus, np.ones((2, 4), np.int32),
                    np.zeros((2, 40, 2), np.int32)))


@pytest.mark.cuda
@pytest.mark.parametrize('pw,ww,maxww', CONFIGS)
def test_card_tables_equal_the_host_completions(device, pw, ww, maxww,
                                                monkeypatch):
    """On the card the call completes on the device, and its table is the
    one the host completion gives."""
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, maxapart=2_000_000,
                        min_marginal_peaks=2, min_local_reads=16)
    bands = _bands(1500, 5, np.float32, num=2_000_000 // RES + maxww + 1,
                   ww_min=min(ww), n_loops=80, depth=60.0)
    n = cuda_complete.window_stats64.launches
    got = engine.hiccups_chrom(bands, cfg, device=device)
    assert cuda_complete.window_stats64.launches == n + 1
    assert len(got) > 0
    _on_the_host(monkeypatch)
    assert engine.hiccups_chrom(bands, cfg, device=device) == got
