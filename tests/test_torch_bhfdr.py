"""The port's pyBHFDR path (global BH, the plain-break freeze gate, the
float64 host completion and ``bhfdr_chrom``, on the CPU through the
kernels' plain twins) against the JAX package and the float64 oracle, on
the synthetic coolers of test_engine_parity.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hicpeaks_tpu.core import engine as jengine
from hicpeaks_tpu.core import poolplan as jpoolplan
from hicpeaks_tpu.core.config import BHFDRConfig
from hicpeaks_tpu.io.coolerlite import CoolerLite
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.ops import hostexact
from hicpeaks_tpu.ops import score as jscore
from hicpeaks_tpu.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.core import engine as tengine
from hicpeaks_tpu_torch.core import hostcomplete
from hicpeaks_tpu_torch.core import poolplan as tpoolplan
from hicpeaks_tpu_torch.ops import score as tscore

from .oracle import reference_impl as oracle
from .oracle.prep import prepare_chrom
from .torch_threads import one_intra_op_thread  # noqa: F401

CFG = BHFDRConfig(pw=1, ww=3, maxww=10, siglevel=0.05, maxapart=2000000)
# (n_bins, seed, depth): test_engine_parity's parity cooler and its
# shallow-coverage cooler, whose freeze gate breaks early
COOLERS = {'parity': (420, 11, 60.0), 'shallow': (380, 17, 12.0)}


@pytest.fixture(scope='module')
def coolers(tmp_path_factory):
    out = {}
    for name, (n_bins, seed, depth) in COOLERS.items():
        path = tmp_path_factory.mktemp('data') / f'{name}.cool'
        uri, _ = synthetic_cooler(str(path), n_bins=n_bins, res=25000,
                                  seed=seed, n_loops=30 if name == 'parity'
                                  else 15, depth=depth)
        clr = CoolerLite(uri)
        d = prepare_chrom(clr, '21', CFG.maxapart, CFG.maxww, CFG.ww)
        want = oracle.bhfdr(d['Md'], d['cMd'], d['B'], d['B'], d['IR'],
                            d['chromLen'], d['num'], pw=CFG.pw, ww=CFG.ww,
                            sig=CFG.siglevel, maxww=CFG.maxww,
                            maxapart=CFG.maxapart, res=clr.binsize)
        out[name] = (clr, want)
    return out


def _bands(clr, dtype):
    return bands_from_cooler(clr, '21', CFG.maxapart, CFG.maxww, CFG.ww,
                             dtype=dtype)


def _assert_tables_match(got, want, rtol):
    assert set(got) == set(want), (
        f'locus sets differ: extra={sorted(set(got) - set(want))[:5]} '
        f'missing={sorted(set(want) - set(got))[:5]}')
    for key in want:
        g, w = got[key], want[key]
        assert tuple(g[:3]) == tuple(w[:3]), f'{key}: geometry'
        np.testing.assert_allclose(np.asarray(g[3:], float),
                                   np.asarray(w[3:], float), rtol=rtol,
                                   atol=1e-300, err_msg=str(key))


def _pvalues(case, dtype, seed=0, n=20000):
    rng = np.random.default_rng(seed)
    p = rng.random(n)
    p[:200] = 10.0 ** rng.uniform(-9, -3, 200)
    p[200:280] = p[200]                 # 80-way tie, significant
    p[280:320] = 0.05 * 0.9             # tie near the boundary
    p[320:400] = 0.05 * 200 / n         # tie on a BH step
    valid = rng.random(n) < 0.9
    if case == 'all_invalid':
        valid[:] = False
    return p.astype(dtype), valid


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('case,sig', [('ties', 0.05), ('ties', 0.31),
                                      ('all_invalid', 0.05), ('ties', 1.0),
                                      ('ties', 1.5)])
def test_global_bh_keep_matches_jax(case, sig, dtype):
    """Bit-equal keep mask and m on the same p-values, sig carried
    through float32 as the JAX engine hands it over."""
    p, valid = _pvalues(case, dtype)
    want_keep, want_m = jscore.global_bh_keep(
        jnp.asarray(p), jnp.asarray(valid), jnp.float32(sig))
    keep, m, iterations = tscore.global_bh_keep(
        torch.from_numpy(p), torch.from_numpy(valid), sig)
    assert keep.dtype == torch.bool and m.dtype == torch.from_numpy(p).dtype
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    assert float(m) == float(want_m) == valid.sum()
    assert iterations >= 1
    if sig >= 1:
        np.testing.assert_array_equal(keep.numpy(), valid)


def _gate_counts():
    """(total, counts) vectors for the bhfdr plan pw=2, ww=5, maxww=10
    (six entries): breaks at the first, a middle and the last entry, none,
    exact ratio boundaries, and seeded random ones."""
    out = [(1000, [299, 0, 0, 0, 0, 0]),          # 0.299 < 0.3: break at 0
           (1000, [300, 300, 300, 75, 10, 0]),    # left < 0.03 at entry 3
           (1000, [300, 210, 147, 103, 72, 50]),  # breaks at the last entry
           (1000, [300, 210, 147, 102, 72, 50]),  # 102/343 < 0.3 at entry 3
           (1000, [300, 670, 0, 0, 0, 0]),        # left ratio exactly 0.03
           (1000, [300, 671, 0, 0, 0, 0]),        # left ratio < 0.03
           (0, [0, 0, 0, 0, 0, 0]),
           (16, [16, 0, 0, 0, 0, 0])]
    rng = np.random.default_rng(5)
    for total in (1, 16, 12345, 214748363):
        for _ in range(10):
            counts, left = [], total
            for _ in range(6):
                c = int(rng.integers(0, max(left // 2, 1) + 1))
                counts.append(c)
                left -= c
            out.append((total, counts))
    return out


@pytest.mark.parametrize('total,counts', _gate_counts())
def test_device_allowed_bhfdr_matches_jax_and_replay(total, counts):
    plan = tuple(jpoolplan.bhfdr_pool_plan(2, 5, 10))
    t_left = jpoolplan.left_threshold(total)
    counts = np.asarray(counts, np.int64)
    host = np.asarray(jpoolplan.emulate_freeze_bhfdr(plan, counts,
                                                     total).allowed)
    jax_gate = np.asarray(jpoolplan.device_allowed_bhfdr(
        jnp.asarray(counts, jnp.int32), np.int32(total), np.int32(t_left),
        plan))
    got = tpoolplan.device_allowed_bhfdr(
        torch.from_numpy(counts).to(torch.int32), total, t_left, plan)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), host)
    np.testing.assert_array_equal(got.numpy(), jax_gate)


def test_gate_cases_break_early_and_late():
    """The seeded gate vectors above do cover early and late breaks."""
    plan = tuple(jpoolplan.bhfdr_pool_plan(2, 5, 10))
    n_allowed = {sum(jpoolplan.emulate_freeze_bhfdr(plan, c, t).allowed)
                 for t, c in _gate_counts()}
    assert {1, 4, 6} <= n_allowed


@pytest.mark.parametrize('exact', [False, True])
def test_bhfdr_to_host_matches_jax(coolers, exact):
    """One fetched bundle of the port's device pipeline, completed on the
    host by the JAX engine's _bhfdr_to_host and by the port's."""
    clr, _ = coolers['shallow']
    bands = _bands(clr, np.float64)
    plan = tuple(jpoolplan.bhfdr_pool_plan(CFG.pw, CFG.ww, CFG.maxww))
    total = bands.candidate_total(CFG.ww, CFG.maxapart // bands.res)
    ops = tengine.bands_to_device(bands, 'cpu')
    t_left = jpoolplan.left_threshold(total)
    route = tengine.resolve_route('auto', 'auto', False, total)
    sh, outs, decision = tengine._scan_front(
        ops, bands, plan, (CFG.pw,), 16, CFG.ww, CFG.maxapart // bands.res,
        CFG.ww, route,
        lambda c: tpoolplan.emulate_freeze_bhfdr(plan, c, total),
        lambda c: tpoolplan.device_allowed_bhfdr(c, total, t_left, plan))
    out = tengine._score_device_bhfdr_compact(
        sh, outs[CFG.pw][0], outs[CFG.pw][1], CFG.siglevel, CFG.ww)
    allowed = np.asarray(decision.allowed)
    assert not allowed.all()          # the shallow cooler breaks early
    fetched = tengine._to_host(out[:10])
    assert int(fetched[0]) > 0 and fetched[9].any()   # gap pixels kept
    ex = None
    if exact:
        ex = (hostexact.ExactCtx(bands, plan, allowed.tolist(), 16),
              CFG.pw, 'K')
    want = jengine._bhfdr_to_host(fetched, None, 1 << 17, CFG.siglevel,
                                  exact=ex)
    got = hostcomplete._bhfdr_to_host(fetched, None, CFG.siglevel, exact=ex)
    assert len(want['x']) > 0
    for k in ('x', 'y', 'O', 'ICE', 'Fold', 'p', 'q'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('name', list(COOLERS))
def test_bhfdr_chrom_matches_jax_and_oracle(coolers, name, dtype):
    clr, want_oracle = coolers[name]
    want = jengine.bhfdr_chrom(_bands(clr, dtype), CFG)
    got = tengine.bhfdr_chrom(_bands(clr, dtype), CFG, device='cpu')
    assert len(want) > 0
    _assert_tables_match(got, want, rtol=1e-12)
    _assert_tables_match(got, want_oracle, rtol=1e-8)
    # the bedpe writers iterate the table: its order is JAX's too
    assert list(got) == list(want)


def test_bhfdr_mesh_checkify_and_gate_overflow_served(coolers):
    """A mesh that is not a TileMesh raises TypeError and a 4-tile CPU
    mesh returns the single-device table; checkify and a candidate total
    past the int32 freeze gate (the host-gate route) return the JAX
    engine's table."""
    from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh
    clr, _ = coolers['parity']
    b = _bands(clr, np.float32)
    with pytest.raises(TypeError, match='TileMesh'):
        tengine.bhfdr_chrom(b, CFG, device='cpu', mesh=object())
    single = tengine.bhfdr_chrom(b, CFG, device='cpu')
    meshed = tengine.bhfdr_chrom(b, CFG, mesh=make_tile_mesh(
        devices=['cpu'] * 4))
    assert len(single) > 0
    assert meshed == single and list(meshed) == list(single)
    want = jengine.bhfdr_chrom(_bands(clr, np.float32), CFG, check=True)
    got = tengine.bhfdr_chrom(b, CFG, device='cpu', check=True)
    assert len(want) > 0
    _assert_tables_match(got, want, rtol=1e-12)
    big = [_bands(clr, np.float32) for _ in range(2)]
    for bb in big:
        bb.candidate_total = lambda *a: 1 << 28
    want = jengine.bhfdr_chrom(big[0], CFG)
    got = tengine.bhfdr_chrom(big[1], CFG, device='cpu')
    _assert_tables_match(got, want, rtol=1e-12)
    assert list(got) == list(want)
