"""The CUDA kernels (hicpeaks_tpu_torch/csrc/) against their plain PyTorch
twins at small shapes, on the card.

These need a CUDA card and nvcc; they carry the ``cuda`` marker and skip
elsewhere.  On a GPU host: ``python -m pytest --noconftest
tests/test_torch_kernels.py`` (tests/conftest.py imports JAX;
chip_smoke.py makes the same checks at the main path's shapes)."""
import numpy as np
import pytest
import torch

from hicpeaks_tpu_torch.core import poolplan
from hicpeaks_tpu_torch.ops import cuda_hist, cuda_scan
from hicpeaks_tpu_torch.ops import scan as twin

from .torch_threads import one_intra_op_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernels have no CPU mode')
    return torch.device('cuda')


def _bands(num_p, Lp, L, seed, device):
    rng = np.random.default_rng(seed)
    raw = ((rng.random((num_p, Lp)) < 0.5)
           * rng.poisson(5.0, (num_p, Lp))).astype(np.float32)
    cband = (raw * rng.random((num_p, Lp))).astype(np.float32)
    drow = np.arange(num_p)[:, None]
    col = np.arange(Lp)[None, :]
    eband = np.where((col < (L - drow)) & (drow >= 3), 1.3, 0.0
                     ).astype(np.float32)
    cand = (raw != 0) & (drow >= 3) & (col < (L - drow))
    return [torch.from_numpy(a).to(device)
            for a in (raw, cband, eband, cand)]


@pytest.mark.parametrize('num_p,Lp,L', [(64, 256, 243), (17, 139, 131),
                                        (8, 384, 380), (96, 128, 97)])
@pytest.mark.parametrize('pw,ww,maxww', [([2], [5], 7), ([1, 2], [3, 5], 10)])
def test_scan_kernels_match_twin(device, num_p, Lp, L, pw, ww, maxww):
    raw, cband, eband, cand = _bands(num_p, Lp, L, num_p + Lp, device)
    plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
    p_list = tuple(sorted(set(pw)))
    got_a = cuda_scan.scan_pass_a(raw, cand, plan, p_list, 8)
    want_a = twin.scan_pass_a(raw, cand, plan, p_list, 8)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a)

    allowed = torch.ones(len(plan), dtype=torch.bool, device=device)
    allowed[-1] = False
    got_b = cuda_scan.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                  p_list, 8)
    want_b = twin.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                              p_list, 8)[2]
    torch.cuda.synchronize()
    for p in p_list:
        for t in range(4):
            assert torch.equal(got_b[p][t], want_b[p][t]), (p, t)


@pytest.mark.parametrize('num_p,Lp,L', [(64, 256, 243), (17, 139, 131)])
@pytest.mark.parametrize('pw,ww,maxww', [(2, 5, 10), (1, 3, 10)])
def test_scan_kernels_match_twin_on_bhfdr_gate(device, num_p, Lp, L, pw, ww,
                                               maxww):
    """The pyBHFDR plan (one p, clean annuli) and its plain-break gate,
    computed on the card from the kernel's own counts."""
    from hicpeaks_tpu_torch.core.poolplan import device_allowed_bhfdr
    raw, cband, eband, cand = _bands(num_p, Lp, L, num_p * Lp, device)
    plan = tuple(poolplan.bhfdr_pool_plan(pw, ww, maxww))
    got_a = cuda_scan.scan_pass_a(raw, cand, plan, (pw,), 16)
    assert torch.equal(got_a, twin.scan_pass_a(raw, cand, plan, (pw,), 16))
    total = int(cand.sum())
    allowed = device_allowed_bhfdr(got_a, total,
                                   poolplan.left_threshold(total), plan)
    assert allowed.tolist() == poolplan.emulate_freeze_bhfdr(
        plan, got_a.cpu().numpy(), total).allowed
    got_b = cuda_scan.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                  (pw,), 16)
    want_b = twin.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                              (pw,), 16)[2]
    torch.cuda.synchronize()
    for t in range(4):
        assert torch.equal(got_b[pw][t], want_b[pw][t]), t


@pytest.mark.parametrize('num_p,Lp,L', [(40, 70, 66), (33, 97, 90),
                                        (64, 256, 243)])
@pytest.mark.parametrize('pw,ww,maxww,thr', [([1, 2], [3, 5], 10, 90),
                                             ([1, 2, 4], [3, 5, 6], 9, 40),
                                             ([0], [1], 1, 2)])
def test_scan_kernels_match_twin_on_drift_readds_and_cut_gate(
        device, num_p, Lp, L, pw, ww, maxww, thr):
    """Multi-pair plans whose drift re-adds reach captured sums (a high
    threshold spreads the captures over the entries), maxw 1, ragged
    shapes, and a gate that cuts the later entries."""
    raw, cband, eband, cand = _bands(num_p, Lp, L, num_p * 7 + Lp, device)
    plan = tuple(poolplan.hiccups_pool_plan(pw, ww, maxww))
    p_list = tuple(sorted(set(pw)))
    got_a = cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr)
    assert torch.equal(got_a, twin.scan_pass_a(raw, cand, plan, p_list, thr))
    for cut in (len(plan), (len(plan) + 1) // 2):
        allowed = torch.zeros(len(plan), dtype=torch.bool, device=device)
        allowed[:cut] = True
        args = (raw, cband, eband, cand, allowed, plan, p_list, thr)
        got_b = cuda_scan.scan_pass_b(*args)
        want_b = twin.scan_pass_b(*args)[2]
        torch.cuda.synchronize()
        for p in p_list:
            for t in range(4):
                assert torch.equal(got_b[p][t], want_b[p][t]), (cut, p, t)


def test_scan_wrappers_refuse_plans_beyond_the_kernel_limits(device):
    raw, cband, eband, cand = _bands(16, 64, 60, 1, device)
    wide = tuple(poolplan.hiccups_pool_plan([2], [5], 24))
    with pytest.raises(ValueError, match='shared memory'):
        cuda_scan.scan_pass_b(raw, cband, eband, cand,
                              torch.ones(len(wide), dtype=torch.bool,
                                         device=device), wide, (2,), 8)
    # six distinct drift re-adds: more than the kernels keep in registers
    many = tuple(poolplan.hiccups_pool_plan([1, 7], [8, 9], 10))
    with pytest.raises(ValueError, match='re-adds'):
        cuda_scan.scan_pass_a(raw, cand, many, (1, 7), 8)


@pytest.mark.parametrize('n,S,C,B', [(5000, 40, 1025, 2), (70000, 128, 513, 1),
                                     (300, 16, 33, 3), (20000, 128, 4097, 2)])
def test_hist_kernel_matches_twin(device, n, S, C, B):
    """Includes a table too large for shared memory (global atomics)."""
    rng = np.random.default_rng(n)
    oc = torch.from_numpy(rng.integers(-1, C + 1, n).astype(np.int32))
    cid = torch.from_numpy(rng.integers(-1, S + 1, (B, n)).astype(np.int32))
    got = cuda_hist.chunk_hist(oc.to(device), cid.to(device), S, C)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_hist.chunk_hist_torch(oc, cid, S, C))


def _hist_stream(n, S, C, B, seed, skew):
    """Counts mostly small (geometric) with a uniform tail over [-1, C],
    ids over [-1, S] with half of them in the trash row 0; ``skew``: 90 %
    of the pixels in cell (0, 0) of every background and most of the rest
    in one hot valid cell (3, 1)."""
    rng = np.random.default_rng(seed)
    oc = np.where(rng.random(n) < 0.7, rng.geometric(0.3, n) - 1,
                  rng.integers(-1, C + 1, n))
    cid = rng.integers(-1, S + 1, (B, n))
    cid[rng.random((B, n)) < 0.5] = 0
    if skew:
        u = rng.random(n)
        oc[u < 0.9] = 0
        cid[:, u < 0.9] = 0
        hot = (u >= 0.9) & (u < 0.99)
        oc[hot] = 1
        cid[:, hot] = 3
    return (torch.from_numpy(oc.astype(np.int32)),
            torch.from_numpy(cid.astype(np.int32)))


@pytest.mark.parametrize('n,S,C,B,skew', [
    (40000, 64, 908, 1, False),       # S*C*4 = 232,448 B: one shared table
    (40000, 64, 909, 1, False),       # one column past it
    (40000, 64, 908, 2, False),
    (40000, 64, 909, 2, False),
    (300000, 48, 16385, 2, False),    # o_cap 16384
    (300000, 56, 131073, 2, False),   # o_cap 131072, the cap
    (100000, 40, 1025, 4, False),     # the multi-pair plan pw=(1, 2)
    (100001, 40, 1025, 2, False),     # n % 4 == 1, 2, 3: rows not aligned
    (100002, 40, 1025, 4, False),
    (100003, 48, 16385, 2, False),
    (200000, 40, 1025, 2, True),      # skewed: the trash cell and a hot cell
    (200003, 48, 16385, 4, True),
    (0, 40, 1025, 2, False),          # an empty stream
    (1000, 16, 33, 9, False),         # more backgrounds than one block takes
    (20000, 128, 4097, 4, False),     # rows that shrink the low table
    (3000, 15000, 5, 4, False),       # rows too many for any shared table
])
def test_hist_kernel_matches_twin_at_edges(device, n, S, C, B, skew):
    oc, cid = _hist_stream(n, S, C, B, n + S + C + B, skew)
    launches = cuda_hist.chunk_hist.launches
    got = cuda_hist.chunk_hist(oc.to(device), cid.to(device), S, C)
    torch.cuda.synchronize()
    assert cuda_hist.chunk_hist.launches == launches + (n > 0)
    assert torch.equal(got.cpu(), cuda_hist.chunk_hist_torch(oc, cid, S, C))


def test_hist_kernel_takes_unaligned_views(device):
    """Rows that start off a 16-byte boundary take the one-pixel loads."""
    oc, cid = _hist_stream(50001, 40, 1025, 2, 5, False)
    oc_d, cid_d = oc.to(device), cid.to(device)
    got = cuda_hist.chunk_hist(oc_d[1:], cid_d[:, 1:].contiguous(), 40, 1025)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), cuda_hist.chunk_hist_torch(
        oc[1:], cid[:, 1:].contiguous(), 40, 1025))


@pytest.mark.parametrize('pw,ww', [((2,), (5,)), ((1, 2), (3, 5))])
def test_hiccups_chrom_on_card_matches_cpu(device, pw, ww):
    """The main path on the card (kernels) gives the CPU run's table
    (twins): the float64 host completion absorbs the ulp-level differences
    of CUDA's f32 log/pow/gammainc."""
    from hicpeaks_tpu_torch.core.config import HiccupsConfig
    from hicpeaks_tpu_torch.core.engine import hiccups_chrom
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops.band import build_bands
    res, L, maxapart, maxww = 10000, 1500, 600000, 10
    num = maxapart // res + maxww + 1
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=L, res=res, seed=1,
                                           depth=40.0, n_loops=60,
                                           decay=0.75,
                                           max_loop_span_bins=num - 12)
    w = np.full(L, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    cfg = HiccupsConfig(pw=pw, ww=ww, maxww=maxww, maxapart=maxapart)

    def table(dev):
        bands = build_bands(b1, b2, ct, w, L, num, min(ww), res)
        return hiccups_chrom(bands, cfg, device=dev)

    launches = cuda_scan.scan_pass_b.launches
    got, want = table(device), table('cpu')
    assert cuda_scan.scan_pass_b.launches == launches + 1
    assert len(want) > 0 and set(got) == set(want)
    for k, v in want.items():
        assert tuple(got[k][:3]) == tuple(v[:3])
        np.testing.assert_allclose(got[k][3:], v[3:], rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize('pw,ww', [(2, 5), (1, 3)])
def test_bhfdr_chrom_on_card_matches_cpu(device, pw, ww):
    """The pyBHFDR path on the card (scan kernels, f32 gammainc of the
    keep superset) gives the CPU run's table: the host recomputes every
    emitted p and q in float64."""
    from hicpeaks_tpu_torch.core.config import BHFDRConfig
    from hicpeaks_tpu_torch.core.engine import bhfdr_chrom
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops.band import build_bands
    res, L, maxapart, maxww = 10000, 1500, 600000, 10
    num = maxapart // res + maxww + 1
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=L, res=res, seed=2,
                                           depth=40.0, n_loops=60,
                                           decay=0.75,
                                           max_loop_span_bins=num - 12)
    w = np.full(L, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    cfg = BHFDRConfig(pw=pw, ww=ww, maxww=maxww, maxapart=maxapart)

    def table(dev):
        bands = build_bands(b1, b2, ct, w, L, num, ww, res)
        return bhfdr_chrom(bands, cfg, device=dev)

    launches = (cuda_scan.scan_pass_a.launches, cuda_scan.scan_pass_b.launches)
    got, want = table(device), table('cpu')
    assert (cuda_scan.scan_pass_a.launches,
            cuda_scan.scan_pass_b.launches) == tuple(n + 1 for n in launches)
    assert len(want) > 0 and list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k][:3]) == tuple(v[:3])
        np.testing.assert_allclose(got[k][3:], v[3:], rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize('caller', ['hiccups', 'bhfdr'])
def test_mesh_of_tiles_on_card_matches_one_device(device, caller):
    """Three tiles on the one card (a device list that repeats the card)
    launch each scan kernel once a tile and give the one-device table,
    in its order."""
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops.band import build_bands
    from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh
    res, L, maxapart, maxww = 10000, 1500, 600000, 10
    num = maxapart // res + maxww + 1
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=L, res=res, seed=3,
                                           depth=40.0, n_loops=60,
                                           decay=0.75,
                                           max_loop_span_bins=num - 12)
    w = np.full(L, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    if caller == 'hiccups':
        cfg, call = HiccupsConfig(maxww=maxww, maxapart=maxapart), \
            engine.hiccups_chrom
    else:
        cfg, call = BHFDRConfig(maxww=maxww, maxapart=maxapart), \
            engine.bhfdr_chrom
    bands = build_bands(b1, b2, ct, w, L, num, 5, res)
    want = call(bands, cfg, device=device)
    launches = cuda_scan.scan_pass_b.launches
    got = call(bands, cfg, mesh=make_tile_mesh(devices=[device] * 3))
    assert cuda_scan.scan_pass_b.launches == launches + 3
    assert len(want) > 0 and got == want and list(got) == list(want)


@pytest.mark.parametrize('caller', ['hiccups', 'bhfdr'])
def test_staging_on_the_card(device, caller):
    """``stage_chrom_arrays`` on the card: pinned host sources, device
    tensors equal to the bands' arrays, an event on the card's one copy
    stream; the pickup hands the staged tensors themselves to the call,
    whose table == the unstaged call's."""
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops import score
    from hicpeaks_tpu_torch.ops.band import build_bands
    res, L, maxapart, maxww = 10000, 1500, 600000, 10
    num = maxapart // res + maxww + 1
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=L, res=res, seed=4,
                                           depth=40.0, n_loops=60,
                                           decay=0.75,
                                           max_loop_span_bins=num - 12)
    w = np.full(L, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    if caller == 'hiccups':
        cfg, call = HiccupsConfig(maxww=maxww, maxapart=maxapart), \
            engine.hiccups_chrom
    else:
        cfg, call = BHFDRConfig(maxww=maxww, maxapart=maxapart), \
            engine.bhfdr_chrom
    want = call(build_bands(b1, b2, ct, w, L, num, 5, res), cfg,
                device=device)
    bands = build_bands(b1, b2, ct, w, L, num, 5, res)
    staged = engine.stage_chrom_arrays.staged
    engine.stage_chrom_arrays(bands, device=device)
    assert engine.stage_chrom_arrays.staged == staged + 1
    rec = bands._staged
    assert rec.device == torch.device('cuda', torch.cuda.current_device())
    assert rec.event is not None
    assert engine._COPY_STREAMS[rec.device] != torch.cuda.current_stream()
    for k, t in rec.tensors.items():
        assert rec.pinned[k].is_pinned(), k
        assert t.device == rec.device, k
        np.testing.assert_array_equal(t.cpu().numpy(), getattr(bands, k))
    raws = []
    real = score.build_sheets

    def build(raw, *a, **k):
        raws.append(raw)
        return real(raw, *a, **k)

    score.build_sheets = build
    try:
        got = call(bands, cfg, device=device)
    finally:
        score.build_sheets = real
    assert rec.event.query()
    assert raws and raws[0] is rec.tensors['raw']
    assert len(want) > 0 and got == want and list(got) == list(want)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    raw, cband, eband, cand = _bands(16, 64, 60, 0, device)
    plan = tuple(poolplan.hiccups_pool_plan([2], [5], 7))
    with pytest.raises(TypeError):
        cuda_scan.scan_pass_a(raw.double(), cand, plan, (2,), 8)
    with pytest.raises(ValueError):
        cuda_scan.scan_pass_a(raw.t(), cand.t(), plan, (2,), 8)
    with pytest.raises(TypeError):
        cuda_hist.chunk_hist(raw.reshape(-1), raw.reshape(1, -1), 4, 4)


@pytest.mark.parametrize('w', [3, 5, 7])
def test_apa_windows_on_the_card_bit_equal_cpu(device, w):
    """APA's window stage has no kernel of its own, but its float64 torch
    ops must give the CPU's bits on the card (window means are compared at
    the last ulp): balanced band, NaN cells, windows off the matrix."""
    from hicpeaks_tpu_torch.ops import apa_ops
    rng = np.random.default_rng(w)
    L, num, k = 900, 120, 4000
    b1 = rng.integers(0, L, 60000)
    b2 = np.minimum(b1 + rng.integers(0, num + 20, b1.size), L - 1)
    key = np.unique(b1 * L + b2)
    b1, b2 = key // L, key % L
    ct = rng.poisson(20.0, b1.size) + 1
    weights = rng.uniform(0.2, 3.0, L)
    weights[rng.integers(0, L, 9)] = np.nan
    xs = rng.integers(-3, L + 3, k)
    ys = np.clip(xs + rng.integers(0, num, k), 0, L + 2)
    out = {}
    for dev in (device, torch.device('cpu')):
        band, nanband = apa_ops.apa_band(b1, b2, ct, weights, L, num, dev)
        norm, ok, means = apa_ops.apa_windows(
            band, nanband, torch.from_numpy(xs).to(dev),
            torch.from_numpy(ys).to(dev), w, L)
        out[dev.type] = [t.cpu().numpy() for t in (norm, ok, means)]
    assert out['cuda'][1].sum() > k // 4
    for a, b in zip(out['cuda'], out['cpu']):
        assert a.tobytes() == b.tobytes()
