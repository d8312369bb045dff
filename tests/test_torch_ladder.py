"""The port's fallback ladder and checkify (hicpeaks_tpu_torch/core/
engine.py; on the CPU the kernels' wrappers run their plain twins)
against the JAX engine's, on the loop-rich synthetic cooler of test_keep_cap_overflow.py:
the host-gate route, every ``scan_backend``, ``bh_backend='host'``, counts
above the histogram's cap, a failed suspect audit and ``check=True``, for
both callers and both band dtypes.

Bars: rtol 1e-12 on every statistic, with identical loci, geometry and
table order, except segmented BH's p and q (``SEGMENTED_RTOL``, stated in
test_torch_engine.py: float32 igamma values of two libraries)."""
import jax
import numpy as np
import pytest
import torch

from hicpeaks_tpu.core import engine as jengine
from hicpeaks_tpu.core import flagship
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu.io.coolerlite import CoolerLite
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.ops import score as jscore
from hicpeaks_tpu.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.core import engine as tengine
from hicpeaks_tpu_torch.core import hostcomplete
from hicpeaks_tpu_torch.ops import cuda_scan
from hicpeaks_tpu_torch.ops import score as tscore

from .test_torch_engine import SEGMENTED_RTOL, _assert_tables_match
from .torch_threads import one_intra_op_thread  # noqa: F401

HCFG = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8, maxapart=2_000_000,
                     min_marginal_peaks=2, min_local_reads=16)
BCFG = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=2_000_000)
CALLERS = {'hiccups': (jengine.hiccups_chrom, tengine.hiccups_chrom, HCFG),
           'bhfdr': (jengine.bhfdr_chrom, tengine.bhfdr_chrom, BCFG)}
DTYPES = [np.float64, np.float32]


@pytest.fixture(scope='module')
def clr(tmp_path_factory):
    path = tmp_path_factory.mktemp('ladder') / 'ladder.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=300, res=25000, seed=3,
                              n_loops=40, depth=80.0, loop_strength=8.0)
    return CoolerLite(uri)


def _bands(clr, dtype):
    return bands_from_cooler(clr, '21', 2_000_000, 8, 3, dtype=dtype)


@pytest.fixture(scope='module')
def jax_tables(clr):
    """The JAX engine's default tables, per (caller, dtype)."""
    return {(name, dt): CALLERS[name][0](_bands(clr, dt), CALLERS[name][2])
            for name in CALLERS for dt in DTYPES}


def _match(got, want, rtol=1e-12):
    assert len(want) > 0
    _assert_tables_match(got, want, rtol)
    assert list(got) == list(want)


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name``; returns the counter list."""
    real, calls = getattr(module, name), []

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)
    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('caller', list(CALLERS))
def test_host_gate_route_matches_jax(clr, caller, dtype, monkeypatch):
    """A candidate total past the device gate's int32: the port's limit
    lowered to reach the route here, JAX's non-fused ladder forced."""
    jfn, tfn, cfg = CALLERS[caller]
    monkeypatch.setenv('HICPEAKS_DISABLE_FUSED', '1')
    want = jfn(_bands(clr, dtype), cfg)
    monkeypatch.setattr(tengine, '_GATE_LIMIT', 1)
    gates = _spy(monkeypatch, tengine.poolplan,
                 f'device_allowed_{caller}')
    _match(tfn(_bands(clr, dtype), cfg, device='cpu'), want)
    assert gates == []


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('caller', list(CALLERS))
@pytest.mark.parametrize('backend', ['validate', 'jnp', 'pallas-interpret'])
def test_scan_backends_match_jax(clr, jax_tables, backend, caller, dtype,
                                 monkeypatch):
    """'jnp' and 'pallas-interpret' run the kernels' wrappers on the fused
    route, as 'auto' does; 'validate' runs the wrappers and the twins on
    the host-gate route.  Every scan backend leaves JAX's table as it
    is."""
    _, tfn, cfg = CALLERS[caller]
    wrapped = _spy(monkeypatch, cuda_scan, 'scan_pass_a')
    gates = _spy(monkeypatch, tengine.poolplan, f'device_allowed_{caller}')
    got = tfn(_bands(clr, dtype), cfg, device='cpu', scan_backend=backend)
    _match(got, jax_tables[(caller, dtype)])
    assert (len(wrapped), len(gates)) == \
        ((1, 0) if backend == 'validate' else (1, 1))


def test_validate_raises_on_a_mismatch(clr, monkeypatch):
    """'validate' asserts the kernel and its twin bit-equal."""
    real = cuda_scan.scan_pass_b

    def off_by_one_ulp(*a):
        out = real(*a)
        p = next(iter(out))
        out[p][0] = torch.nextafter(out[p][0], out[p][0] + 1)
        return out
    monkeypatch.setattr(cuda_scan, 'scan_pass_b', off_by_one_ulp)
    with pytest.raises(AssertionError, match='pass B backend mismatch'):
        tengine.bhfdr_chrom(_bands(clr, np.float32), BCFG, device='cpu',
                            scan_backend='validate')


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('caller', list(CALLERS))
def test_host_bh_matches_jax(clr, caller, dtype):
    """``bh_backend='host'``: the dense scorer, float64 BH on the host."""
    jfn, tfn, cfg = CALLERS[caller]
    want = jfn(_bands(clr, dtype), cfg, bh_backend='host')
    _match(tfn(_bands(clr, dtype), cfg, device='cpu', bh_backend='host'),
           want)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('bh', ['auto', 'host'])
def test_counts_above_the_histogram_cap(clr, bh, dtype):
    """A max count above 2^17: device segmented BH under 'auto', the dense
    scorer under 'host'."""
    cfg = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=2_000_000)
    deep = [_bands(clr, dtype) for _ in range(2)]
    for b in deep:
        b.max_count = float((1 << 17) + 1)
    want = jengine.hiccups_chrom(deep[0], cfg, bh_backend=bh)
    got = tengine.hiccups_chrom(deep[1], cfg, device='cpu', bh_backend=bh)
    _match(got, want, SEGMENTED_RTOL if bh == 'auto' else 1e-12)


def _fail_audit(monkeypatch, module, target):
    """Make ``module``'s suspect audit fail for the background ``target`` =
    (p, kind): its device keep thresholds raised far above every count, so
    significant cells hold pixels below them; in the host completion and,
    for the port, in the device one."""
    real = module._compact_to_host

    def audited(fetched, *a, **k):
        exact, sus = k.get('exact'), k.get('sus')
        if exact and tuple(exact[1:]) == target:
            if sus is not None:         # JAX's suspect bundle
                k['sus'] = tuple(sus[:6]) + (np.asarray(sus[6]) + 10 ** 6,)
            elif getattr(fetched, 'sus', None) is not None:     # the port's
                fetched = fetched._replace(sus=fetched.sus._replace(
                    thr=np.asarray(fetched.sus.thr) + 10 ** 6))
        return real(fetched, *a, **k)
    monkeypatch.setattr(module, '_compact_to_host', audited)
    if not hasattr(module, 'complete_on_device'):
        return
    real_device = module.complete_on_device

    def audited_device(sh, out, bgs, ctx, sig):
        thr = out.sus.thr.clone()
        for b, (p, _, kind, _) in enumerate(bgs):
            if (p, kind) == target:
                thr[b] += 10 ** 6
        return real_device(sh, out._replace(sus=out.sus._replace(thr=thr)),
                           bgs, ctx, sig)
    monkeypatch.setattr(module, 'complete_on_device', audited_device)


@pytest.mark.parametrize('dtype', DTYPES)
def test_failed_audit_rescores_that_background_dense(clr, jax_tables, dtype,
                                                     monkeypatch, caplog):
    """One background's audit fails in both packages: each re-scores that
    background alone with the dense scorer, and its pair partner keeps
    its compact result."""
    _fail_audit(monkeypatch, jengine, (2, 'Y'))
    want = jengine.hiccups_chrom(_bands(clr, dtype), HCFG)
    _fail_audit(monkeypatch, tengine, (2, 'Y'))
    dense = _spy(monkeypatch, tengine, '_score_dense')
    with caplog.at_level('WARNING'):
        got = tengine.hiccups_chrom(_bands(clr, dtype), HCFG, device='cpu')
    assert len(dense) == 1
    assert any('falling back to the dense scorer' in r.message
               for r in caplog.records)
    _match(got, want)
    assert want != jax_tables[('hiccups', dtype)]


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('caller', list(CALLERS))
def test_checkify_matches_jax(clr, caller, dtype):
    jfn, tfn, cfg = CALLERS[caller]
    want = jfn(_bands(clr, dtype), cfg, check=True)
    _match(tfn(_bands(clr, dtype), cfg, device='cpu', check=True), want)


@pytest.mark.parametrize('caller', list(CALLERS))
def test_checkify_catches_nan_corruption(caller):
    """test_checkify.py's corruption: one in-band raw pixel set to NaN."""
    bands = flagship.demo_inputs(L=256, num=64, dtype='float32')
    bands.raw[10, 50] = np.nan
    kw = dict(pw=1, ww=3) if caller == 'bhfdr' else dict(pw=(1,), ww=(3,))
    cfg = type(CALLERS[caller][2])(maxww=8, maxapart=40 * bands.res,
                                   min_marginal_peaks=2, **kw)
    with pytest.raises(FloatingPointError, match=r'NaN in raw at \(10, 50\)'):
        CALLERS[caller][1](bands, cfg, device='cpu', check=True)


def test_checkify_index_check_names_the_pixel():
    d = torch.tensor([[3, 9]], dtype=torch.int32)
    x = torch.tensor([[5, 95]], dtype=torch.int32)
    tengine._check_in_band(torch.tensor([1]), d, x, num_p=16, L=100)
    with pytest.raises(IndexError, match=r'\(9, 95\)'):
        tengine._check_in_band(torch.tensor([2]), d, x, num_p=16, L=100)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_segmented_bh_matches_jax(dtype):
    """The sort-based segmented BH against JAX's ``lax.sort`` form, on
    p-values with ties across and inside segments."""
    rng = np.random.default_rng(5)
    shape = (24, 96)
    p = rng.choice(rng.random(300), size=shape).astype(dtype)
    seg = rng.integers(1, 9, size=shape).astype(np.int32)
    valid = rng.random(shape) < 0.8
    want = np.asarray(jax.jit(jscore.segmented_bh)(p, seg, valid))
    got = tscore.segmented_bh(torch.from_numpy(p), torch.from_numpy(seg),
                              torch.from_numpy(valid)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_dense_host_completion_copies_match_jax():
    rng = np.random.default_rng(6)
    O = np.floor(rng.gamma(2.0, 4.0, size=(16, 64))).astype(np.float32)
    cid = rng.integers(0, 40, size=O.shape).astype(np.int32)
    valid = rng.random(O.shape) < 0.7
    for got, want in zip(hostcomplete.host_chunk_dense(O, cid, valid, 0.05),
                         jscore.host_chunk_dense(O, cid, valid, 0.05)):
        np.testing.assert_array_equal(got, want)
    pv = rng.random(O.shape)
    np.testing.assert_array_equal(hostcomplete.host_bh(pv, cid, valid),
                                  jscore.host_bh(pv, cid, valid))


@pytest.mark.parametrize('args,want', [
    (('auto', 'auto', False, 10, 500), ('kernel', True, True, 'device', 1024)),
    (('pallas', 'device', False, 10, None),
     ('kernel', True, True, 'device', None)),
    (('jnp', 'auto', False, 10, 500), ('kernel', True, True, 'device', 1024)),
    (('pallas-interpret', 'device', False, 10, None),
     ('kernel', True, True, 'device', None)),
    (('validate', 'auto', False, 10, 500),
     ('validate', False, True, 'device', 1024)),
    (('auto', 'auto', False, 1 << 28, 500),
     ('kernel', False, True, 'device', 1024)),
    (('auto', 'auto', False, 10, (1 << 17) + 1),
     ('kernel', False, False, 'device', None)),
    (('auto', 'host', False, 10, 500), ('kernel', False, False, 'host', None)),
    (('auto', 'host', False, 10, None), ('kernel', False, False, 'host', None)),
    (('auto', 'auto', True, 10, 500), ('kernel', False, False, 'device', 1024)),
])
def test_resolve_route(args, want):
    r = tengine.resolve_route(*args)
    assert (r.scan, r.device_gate, r.batched, r.bh, r.o_cap) == want
    assert r.check == args[2]
