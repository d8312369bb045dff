"""The batched pyHICCUPS scorer's fused kernels (csrc/score_fused.cu
through ops/cuda_score.py) against the eager chain (ops/score) that stays
their twin.

On the CPU the wrappers run their twins, so these tests hold the fused
route's orchestration (``engine._compact_fused``: the flags, the
histogram, the keep and suspect masks, the compactions, the gathered
values and the postcheck's prod handle) to the eager chain's bundle, and
the engine's choice of route: only the unchecked batched scorer with
float32 sheets on a card takes the kernels, never the CPU, checkify,
float64 bands, the tiles, pyBHFDR or the dense and segmented scorers.
The tests marked ``cuda`` hold the kernels to the eager chain bit for bit
on the card, at chr1's size and on planted edge cells
(``python -m pytest --noconftest tests/test_torch_score_fused.py -m
cuda``).  Only the port is imported (no JAX)."""
import types

import numpy as np
import pytest
import torch

from hicpeaks_tpu_torch.core import engine
from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu_torch.io.synth import synthesize_chrom
from hicpeaks_tpu_torch.ops import cuda_score, score
from hicpeaks_tpu_torch.ops.band import build_bands
from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh

from .torch_threads import one_intra_op_thread  # noqa: F401

RES = 25000
PAIRS = {'B2': ((2,), (5,)), 'B6': ((1, 2, 4), (3, 5, 7))}
MAXAPART = 2_000_000


def _cfg(pairs, **kw):
    pw, ww = PAIRS[pairs]
    return HiccupsConfig(pw=pw, ww=ww, maxww=10, maxapart=MAXAPART,
                         min_marginal_peaks=2, min_local_reads=16, **kw)


def _bands(pairs, dtype=np.float32, n_bins=260, seed=11):
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=n_bins, res=RES,
                                           seed=seed, n_loops=30, depth=60.0)
    w = np.full(n_bins, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    return build_bands(b1, b2, ct, w, n_bins, MAXAPART // RES + 11,
                       min(PAIRS[pairs][1]), RES, chrom='21', dtype=dtype)


def _capture(monkeypatch, call):
    """(the table of ``call``, the arguments of its _compact_batched)."""
    seen = []
    real = engine._compact_batched

    def spy(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    with monkeypatch.context() as m:
        m.setattr(engine, '_compact_batched', spy)
        table = call()
    assert len(seen) == 1
    return table, seen[0]


def _names(monkeypatch):
    """The engine's span names, recorded as they open."""
    names = []
    real = engine.span

    def spy(name):
        names.append(name)
        return real(name)
    monkeypatch.setattr(engine, 'span', spy)
    return names


def _as_if_on_a_card(monkeypatch):
    """``cuda_score.serves`` judging CPU sheets as if they lay on a card,
    so its other conditions decide; counts its True answers."""
    real = cuda_score.serves
    said = []

    def serves(sh, SV, EV, check):
        card = types.SimpleNamespace(device=torch.device('cuda'),
                                     dtype=sh.raw.dtype)
        said.append(real(sh._replace(raw=card), SV, EV, check))
        return said[-1]
    monkeypatch.setattr(cuda_score, 'serves', serves)
    return said


def _same_bundle(got, want, gather_at):
    """Two scorer records are the same: every tensor equal with one dtype,
    the suspects field for field, and the prod handle's values those of
    the dense prod at the ``gather_at`` pixels of each background."""
    assert type(got) is type(want) is score.Compacted
    for f in ('cnt', 'd', 'x', 'O', 'ICE', 'Fold', 'cid', 'hist'):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        assert torch.equal(g, w), f
    assert (got.sus is None) == (want.sus is None)
    if want.sus is not None:
        for f, g, w in zip(score.Suspects._fields, got.sus, want.sus):
            assert g.dtype == w.dtype and torch.equal(g, w), f'suspects {f}'
    prod = want.prod
    for b, (d, x) in enumerate(gather_at):
        vals = engine._gather_prod((got.prod, b), list(zip(x, x + d)))
        assert vals.tobytes() == prod[b, d, x].cpu().numpy().tobytes(), b


def _pixels_of(bundle, num_p, Lp, n=400, seed=0):
    """Each background's kept pixels and ``n`` pixels drawn anywhere in
    the band, as (d, x) int lists."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(bundle.cnt.shape[0]):
        k = int(bundle.cnt[b])
        d = np.r_[bundle.d[b, :k].cpu().numpy(), rng.integers(0, num_p, n)]
        x = np.r_[bundle.x[b, :k].cpu().numpy(), rng.integers(0, Lp, n)]
        out.append((d.astype(np.int64), x.astype(np.int64)))
    return out


def _eager(a, kw):
    """The eager chain's bundle on _compact_batched's arguments."""
    real = cuda_score.serves
    cuda_score.serves = lambda *_: False
    try:
        return engine._compact_batched(*a, **kw)
    finally:
        cuda_score.serves = real


# ---- on the CPU: the twins, the orchestration and the route


def test_serves_only_the_unchecked_float32_scorer_on_a_card():
    def t(kind='cuda', dtype=torch.float32):
        return types.SimpleNamespace(device=torch.device(kind), dtype=dtype)

    def sh(**kw):
        return types.SimpleNamespace(**dict(dict(raw=t(), cband=t(), IR=t(),
                                                 Bprod=t()), **kw))
    planes = [t()] * 6
    assert cuda_score.serves(sh(), planes, planes, False)
    assert not cuda_score.serves(sh(), planes, planes, True)
    assert not cuda_score.serves(sh(raw=t('cpu')), planes, planes, False)
    for k in ('cband', 'IR', 'Bprod'):
        assert not cuda_score.serves(sh(**{k: t(dtype=torch.float64)}),
                                     planes, planes, False), k
    f64 = planes[:5] + [t(dtype=torch.float64)]
    assert not cuda_score.serves(sh(), f64, planes, False)
    assert not cuda_score.serves(sh(), planes, f64, False)
    many = [t()] * (cuda_score.MAX_B + 1)
    assert not cuda_score.serves(sh(), many, many, False)
    assert cuda_score.serves(sh(), many[:-1], many[:-1], False)


@pytest.mark.parametrize('pairs', ['B2', 'B6'])
def test_fused_bundle_equals_the_eager_chains(pairs, monkeypatch):
    """``engine._compact_fused`` (the twins on the CPU) hands on the eager
    chain's bundle on the main path's own arguments: counts, pixels, O,
    ICE, Fold, chunks, histogram, the suspect bundle with its thresholds,
    and prod at the kept pixels and elsewhere through its handle."""
    table, (a, kw) = _capture(monkeypatch, lambda: engine.hiccups_chrom(
        _bands(pairs), _cfg(pairs), device='cpu'))
    assert len(table) > 0 and kw['exact_mode']
    want = engine._compact_batched(*a, **kw)
    got = engine._compact_fused(
        *a, **{k: v for k, v in kw.items() if k != 'check'})
    assert isinstance(got.prod, cuda_score.PlaneProd)
    assert int(want.cnt.sum()) > 0 and int(want.sus.cnt.sum()) > 0
    _same_bundle(got, want, _pixels_of(want, *want.prod.shape[1:]))


@pytest.mark.parametrize('pairs', ['B2', 'B6'])
def test_fused_route_gives_the_eager_table(pairs, monkeypatch):
    """Where the kernels serve, the call takes the fused route once, inside
    the scorer's span, and its table is the eager route's."""
    bands, cfg = _bands(pairs), _cfg(pairs)
    want = engine.hiccups_chrom(bands, cfg, device='cpu')
    said = _as_if_on_a_card(monkeypatch)
    names = _names(monkeypatch)
    got = engine.hiccups_chrom(bands, cfg, device='cpu')
    assert said == [True] and got == want and len(got) > 0
    at = names.index('hicpeaks.score_fused')
    assert names.count('hicpeaks.score_fused') == 1
    assert names[at - 1] == 'hicpeaks.score'


def _bhfdr(bands, device='cpu', **kw):
    return engine.bhfdr_chrom(bands, BHFDRConfig(pw=2, ww=5, maxww=10,
                                                 maxapart=MAXAPART),
                              device=device, **kw)


ROUTES = {
    'cpu': lambda b, c: engine.hiccups_chrom(b, c, device='cpu'),
    'check': lambda b, c: engine.hiccups_chrom(b, c, device='cpu',
                                               check=True),
    'dense': lambda b, c: engine.hiccups_chrom(b, c, device='cpu',
                                               bh_backend='host'),
    'tiles': lambda b, c: engine.hiccups_chrom(
        b, c, mesh=make_tile_mesh(devices=['cpu'] * 2)),
    'bhfdr': lambda b, c: _bhfdr(b),
    'segmented': lambda b, c: engine.hiccups_chrom(b, c, device='cpu'),
    'float64': lambda b, c: engine.hiccups_chrom(b, c, device='cpu'),
}


@pytest.mark.parametrize('route', list(ROUTES))
def test_other_routes_keep_the_eager_chain(route, monkeypatch):
    """The CPU, checkify, the dense scorer, the tiles, pyBHFDR, segmented
    BH and float64 bands never take the kernels: judged as if on a card
    (all but 'cpu'), no call opens ``hicpeaks.score_fused`` and no kernel
    wrapper is called."""
    if route != 'cpu':
        _as_if_on_a_card(monkeypatch)
    if route == 'segmented':      # a count cap below the band's counts
        monkeypatch.setattr(engine, '_MAX_O_CAP', 1)
    calls = []
    for n in ('score_observe', 'score_keep', 'score_gather'):
        monkeypatch.setattr(cuda_score, n,
                            lambda *a, n=n, **k: calls.append(n))
    names = _names(monkeypatch)
    bands = _bands('B2', np.float64 if route == 'float64' else np.float32)
    ROUTES[route](bands, _cfg('B2'))
    assert 'hicpeaks.score_fused' not in names and not calls
    assert 'hicpeaks.score' in names


def test_gather_leaves_prod_out_where_not_asked():
    """The suspects' prod is gathered only where asked for: without it the
    suspect set's outputs are the same but for the last."""
    sh, SV, EV, wis = _planted('cpu')
    C = 1024
    idx = [torch.tensor([[0, 3, 15], [2, 7, 9]], dtype=torch.int32),
           torch.tensor([[5, 100, 2047], [0, 1999, 64]], dtype=torch.int32)]
    full = cuda_score.score_gather(sh, SV, EV, wis, idx, idx, C)
    lean = cuda_score.score_gather(sh, SV, EV, wis, idx, idx, C, prod=False)
    assert len(full) == 8 and len(lean) == 7
    for g, w in zip(lean, full):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ---- on the card


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


_CHR1 = {}


def _chr1(pairs):
    """hg38 chr1's band at 10 kb and a 10 Mb span (1016 x 24,960), and the
    configuration of ``pairs`` at that span."""
    if 'bands' not in _CHR1:
        L, res, maxapart = 24896, 10000, 10_000_000
        b1, b2, ct, _, bias = synthesize_chrom(
            n_bins=L, res=res, seed=42, depth=40.0, n_loops=2000,
            decay=0.75, max_loop_span_bins=900)
        w = np.full(L, np.nan)
        w[bias > 0] = 1.0 / bias[bias > 0]
        _CHR1['bands'] = build_bands(b1, b2, ct, w, L, maxapart // res + 11,
                                     3, res, chrom='1', dtype=np.float32)
    pw, ww = PAIRS[pairs]
    return _CHR1['bands'], HiccupsConfig(pw=pw, ww=ww, maxww=10,
                                         maxapart=10_000_000)


def _held_to_twins(a, kw):
    """Each kernel against its twin on the main path's own arguments."""
    sh, SV, EV, wis, sig, o_cap = a[:6]
    margin, S = kw['margin'], kw['s_rows']
    C = o_cap + 1
    got = cuda_score.score_observe(sh, SV, EV, wis, margin, S, C)
    want = cuda_score.score_observe_twin(sh, SV, EV, wis, margin, S, C)
    for name, g, w in zip(('counts', 'chunks', 'flags'), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    oc, cid0, flags = got
    hist = score.chunk_hist(oc, cid0, S, C)
    _, thr2 = score.chunk_thresholds(hist, len(SV), S, sig,
                                     engine._BH_SLACK, torch.float32)
    for exact in (False, True):
        masks = cuda_score.score_keep(sh.raw, sh.gap_drop, cid0, flags,
                                      thr2, sig, C, exact)
        w = cuda_score.score_keep_twin(sh.raw, sh.gap_drop, cid0, flags,
                                       thr2, sig, C, exact)
        assert torch.equal(masks[0], w[0])
        assert exact == (masks[1] is not None)
        assert masks[1] is None or torch.equal(masks[1], w[1])
    kept, sus = (score.compact_mask_batched(m)[1:] for m in masks)
    g = cuda_score.score_gather(sh, SV, EV, wis, kept, sus, C)
    w = cuda_score.score_gather_twin(sh, SV, EV, wis, kept, sus, C)
    assert len(g) == len(w) == 8
    for i, (x, y) in enumerate(zip(g, w)):
        assert x.dtype == y.dtype and torch.equal(x, y), i


@pytest.mark.cuda
@pytest.mark.parametrize('pairs', ['B2', 'B6'])
def test_kernels_equal_the_eager_chain_at_chr1(device, pairs, monkeypatch):
    """At chr1's size, B = 2 (pw 2, ww 5) and B = 6 (the QuickStart's
    three pairs): the call launches each dense kernel once, the gather
    once and once more a postcheck, and gives the eager route's table; on its arguments each kernel equals its twin and
    the fused bundle equals the eager chain's, tensor for tensor."""
    bands, cfg = _chr1(pairs)
    counted = (cuda_score.score_observe, cuda_score.score_keep,
               cuda_score.score_gather, cuda_score.score_prod)
    launches = [f.launches for f in counted]
    got, (a, kw) = _capture(monkeypatch, lambda: engine.hiccups_chrom(
        bands, cfg, device=device))
    observe, keep, gather, postcheck = (f.launches - n for f, n in
                                        zip(counted, launches))
    assert (observe, keep, gather) == (1, 1, 1 + postcheck)
    with monkeypatch.context() as m:
        m.setattr(cuda_score, 'serves', lambda *_: False)
        want = engine.hiccups_chrom(bands, cfg, device=device)
    assert got == want and len(got) > 0
    _held_to_twins(a, kw)
    fused = engine._compact_fused(
        *a, **{k: v for k, v in kw.items() if k != 'check'})
    eager = _eager(a, kw)
    assert int(eager.sus.cnt.sum()) > 0
    _same_bundle(fused, eager, _pixels_of(eager, *eager.prod.shape[1:],
                                          n=20000))
    torch.cuda.synchronize()


def _planted(device):
    """Sheets and planes whose E = Bprod exactly (IR 1, SV = EV = 1) is
    planted at each chunk edge and one ulp either side, at values whose t
    = 3 log2(E) lies within the margin of an integer or just outside it,
    at 0, below 0, subnormal and near the float32 maximum; with EV = 0
    cells, rows below each window radius, columns past the band's end and
    gap and candidate masks drawn at random."""
    num_p, Lp, L = 16, 2048, 2000
    edges = cuda_score.edge_table(device).cpu()
    lv = edges[0, 2:400]
    lv = lv[torch.isfinite(lv)]
    up = torch.nextafter(lv, torch.full_like(lv, float('inf')))
    down = torch.nextafter(lv, torch.zeros_like(lv))
    k = torch.arange(-60, 60, dtype=torch.float64)
    near = torch.cat([torch.pow(2.0, (k + s) / 3.0) for s in
                      (1e-7, -1e-7, 3e-5, -3e-5, 1e-3)]).float()
    special = torch.tensor([0.0, -1.0, -0.0, 1e-40, 1e-45, 3e38, 1.0, 0.5])
    E = torch.cat([lv, up, down, near, special])
    rng = np.random.default_rng(5)
    bprod = torch.from_numpy(rng.uniform(0.5, 2.0, (num_p, Lp))).float()
    flat = bprod.reshape(-1)
    at = torch.from_numpy(rng.permutation(num_p * Lp)[:E.numel()])
    flat[at] = E
    raw = torch.from_numpy(rng.poisson(3.0, (num_p, Lp))).float()
    raw[:, -100:] = 7.0
    sh = engine.Sheets(
        raw=raw, cband=raw * 0.75, eband=raw, IR=torch.ones(num_p),
        Bprod=bprod, gap_drop=torch.from_numpy(rng.random((num_p, Lp)) < 0.1),
        cand=torch.from_numpy(rng.random((num_p, Lp)) < 0.9), L=L)
    sh = engine.Sheets(*(t.to(device) if isinstance(t, torch.Tensor) else t
                         for t in sh))
    SV, EV = [], []
    for b in range(2):
        ev = torch.ones(num_p, Lp)
        ev[torch.from_numpy(rng.random((num_p, Lp)) < 0.05)] = 0.0
        SV.append(torch.ones(num_p, Lp, device=device))
        EV.append(ev.to(device))
    return sh, SV, EV, [3, 5]


@pytest.mark.cuda
def test_kernels_equal_the_eager_chain_on_planted_cells(device):
    """On the planted cells each kernel equals its twin, and the fused
    bundle the eager chain's, in exact mode (the suspects set aside) and
    without it."""
    sh, SV, EV, wis = _planted(device)
    for exact in (True, False):
        a = (sh, SV, EV, wis, 0.05, 1023)
        kw = dict(exact_mode=exact, margin=2e-4 if exact else 0.0,
                  s_rows=score.chunk_rows(1024, 0.05))
        _held_to_twins(a, dict(kw, margin=2e-4))
        fused = engine._compact_fused(*a, **kw)
        eager = _eager(a, kw)
        _same_bundle(fused, eager, _pixels_of(eager, *sh.raw.shape, n=5000))
        assert exact == (eager.sus is not None) and (
            not exact or int(eager.sus.cnt.sum()) > 0)
    torch.cuda.synchronize()
