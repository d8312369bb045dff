"""JAX's call forms on the port: every public function and public class
method that a module of both packages defines takes JAX's positional
parameters first, with the same names and defaults, and every parameter
the port adds has a default, so a JAX call binds unchanged.  Then the
behaviour behind the defaults: ``device`` is the card unless the caller
names the CPU (without CUDA the plain call raises RuntimeError), the
mesh's own device under a ``mesh``; the engine's mesh is JAX's third
positional argument; ``sharded_bands_from_cooler`` builds float64 bands
by default, as JAX does."""
import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import hicpeaks_tpu
import hicpeaks_tpu_torch
from hicpeaks_tpu.io.coolerlite import CoolerLite as JCoolerLite
from hicpeaks_tpu.io.coolerlite import binnify, create_cooler_file
from hicpeaks_tpu.io.synth import synthesize_chrom
from hicpeaks_tpu.parallel import multihost as jmultihost
from hicpeaks_tpu_torch import api as tapi
from hicpeaks_tpu_torch.core import engine as tengine
from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
from hicpeaks_tpu_torch.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.parallel import multihost as tmultihost
from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh

from .torch_threads import one_intra_op_thread  # noqa: F401

# The port's deliberate departures from JAX's signatures, by module and
# qualified name; each must still depart (a stale entry fails)
ALLOWED = {
    'ops.score.compact_mask':
        'no cap: the port sizes the compaction from its count (the '
        'keep-cap tiers are not ported)',
    'ops.score.compact_mask_batched':
        'no cap: the port sizes the compaction from its count (the '
        'keep-cap tiers are not ported)',
    'parallel.tiles.ir_sharded':
        'takes the per-tile tensor list where JAX took one sharded array',
    'parallel.tiles.chunk_hist_sharded':
        'takes per-tile tensor lists where JAX took sharded arrays, and '
        'no hist_backend string',
    'parallel.tiles.scan_pass_a_sharded':
        'takes per-tile tensor lists and the pass-A kernel wrapper where '
        'JAX took sharded arrays and a scan_backend string',
    'parallel.tiles.scan_pass_b_sharded':
        'takes per-tile tensor lists and the pass-B kernel wrapper where '
        'JAX took sharded arrays and a scan_backend string',
}
# What the port leaves out of JAX's public API, by module or by module and
# name, each with its reason: the module it moved to, or ROADMAP's "Do not
# port" (a stale entry fails)
_SCORE_HOST = ('float64 host completion: moved to core.hostcomplete, '
               'beside the engine that calls it')
NOT_PORTED = {
    'core.flagship':
        'ROADMAP "Do not port": the jitted one-step demo for '
        '__graft_entry__.py and the TPU benchmarks',
    'ops.pallas_scan':
        'the Pallas scans: ported as hand-written CUDA, ops.cuda_scan on '
        'csrc/scan_pass_a.cu and csrc/scan_pass_b.cu',
    'ops.pallas_hist':
        'the Pallas histogram: ported as hand-written CUDA, ops.cuda_hist '
        'on csrc/chunk_hist.cu',
    'cli.common.enable_compilation_cache':
        'ROADMAP "Do not port": the XLA compilation cache; eager PyTorch '
        'compiles nothing',
    'ops.scan.scan_debug_states':
        'ROADMAP "Do not port": a testing hook only JAX\'s tests/test_scan.py '
        'calls',
    'parallel.launch.global_tile_mesh':
        'moved to parallel.multihost.global_tile_mesh, which takes the '
        'process\'s own devices',
    'parallel.tiles.shard_map':
        'a JAX version shim; the port runs its tiles one by one '
        '(parallel.tiles), with no shard_map',
    'ops.score.bias_product_host':
        'the host Bprod precompute: ops.score.build_sheets derives Bprod on '
        'the device',
    'ops.score.build_sheets_device':
        'moved to ops.score.build_sheets (no jit, and no packed slab: '
        'ROADMAP "Do not port" _SlabEnc)',
    'ops.score.gap_reject_host':
        'the host gap filter: ops.score.gap_reject_device runs in '
        'ops.score.build_sheets',
    'ops.score.gap_vector':
        'gap bins from a dense cband; the bands carry ``gap`` from '
        'ops.band, and nothing in JAX calls it',
    'ops.score.chunk_bh_histogram':
        'per-pixel chunked q on the device: the engine keeps a superset by '
        'ops.score.chunk_thresholds/chunk_keep and completes q in '
        'core.hostcomplete',
    'ops.score.chunk_bh_keep':
        'moved to ops.score.chunk_thresholds and chunk_keep, called by '
        'core.engine._keep_batched',
    'ops.score.chunk_bh_keep_batched':
        'moved to ops.score.chunk_thresholds and chunk_keep, called by '
        'core.engine._keep_batched',
    'ops.score.chunk_hist_split':
        'ROADMAP "Do not port": the split histogram cut MXU work; the CUDA '
        'histogram (ops.cuda_hist) sends the tail to atomics',
    'ops.score.rank_counts':
        'global ranks by a compare-reduce scan; ops.score.global_bh_keep '
        'counts them, and nothing in JAX calls it',
    'ops.score.host_bh': _SCORE_HOST,
    'ops.score.host_bh_complete': _SCORE_HOST,
    'ops.score.host_chunk_complete':
        'float64 host completion: core.hostcomplete._compact_to_host '
        'looks p and q up in the tables of core.hostcomplete.chunk_qtab',
    'ops.score.host_chunk_dense': _SCORE_HOST,
    'ops.score.host_chunk_qtab64': _SCORE_HOST,
}
DEVICE_DEFAULTS = (None, 'cuda')
_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)
_VAR = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)


def _modules(pkg):
    root = os.path.dirname(pkg.__file__)
    out = set()
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith('.py'):
                rel = os.path.relpath(os.path.join(dirpath, name), root)
                out.add(rel[:-3].replace(os.sep, '.'))
    return out


SHARED = sorted(_modules(hicpeaks_tpu) & _modules(hicpeaks_tpu_torch))


def _import(pkg, rel):
    if rel == '__init__':
        return importlib.import_module(pkg)
    return importlib.import_module(f'{pkg}.{rel.removesuffix(".__init__")}')


def _public(mod):
    """{name: function} of the module's own public functions and its own
    classes' public methods and ``__init__``, as 'Class.method'."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith('_') or getattr(obj, '__module__', None) \
                != mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            for mname, m in vars(obj).items():
                if isinstance(m, (staticmethod, classmethod)):
                    m = m.__func__
                if inspect.isfunction(m) and (not mname.startswith('_')
                                              or mname == '__init__'):
                    out[f'{name}.{mname}'] = m
    return out


def _jax_api(mod):
    """The names of :func:`_public`, and the jitted functions the module
    defines (``jax.jit`` hides them from ``inspect.isfunction``)."""
    names = set(_public(mod))
    for name, obj in vars(mod).items():
        wrapped = getattr(obj, '__wrapped__', None)
        if not name.startswith('_') and inspect.isfunction(wrapped) and \
                wrapped.__module__ == mod.__name__:
            names.add(name)
    return names


def _has(mod, qualname):
    obj = mod
    for part in qualname.split('.'):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _same(a, b):
    if a is b:
        return True
    try:
        return type(a) is type(b) and bool(a == b)
    except (TypeError, ValueError):
        return False


def _default_ok(jp, tp):
    if tp.name == 'device':
        return tp.default in DEVICE_DEFAULTS
    return _same(jp.default, tp.default)


def departures(jfn, tfn):
    """What keeps a JAX call of ``jfn`` from binding the same way on
    ``tfn``; empty when none."""
    jps = list(inspect.signature(jfn).parameters.values())
    tps = list(inspect.signature(tfn).parameters.values())
    tnamed = {p.name: p for p in tps}
    out = []
    jpos = [p for p in jps if p.kind in _POSITIONAL]
    tpos = [p for p in tps if p.kind in _POSITIONAL]
    for i, jp in enumerate(jpos):
        if i >= len(tpos):
            out.append(f'positional {i} {jp.name!r} is missing')
        elif tpos[i].name != jp.name:
            out.append(f'positional {i} is {tpos[i].name!r}, JAX has '
                       f'{jp.name!r}')
        elif not _default_ok(jp, tpos[i]):
            out.append(f'{jp.name!r} defaults to {tpos[i].default!r}, JAX '
                       f'to {jp.default!r}')
    for jp in jps:
        if jp.kind == inspect.Parameter.KEYWORD_ONLY:
            tp = tnamed.get(jp.name)
            if tp is None or tp.kind not in _POSITIONAL + (jp.kind,):
                out.append(f'keyword {jp.name!r} is missing')
            elif not _default_ok(jp, tp):
                out.append(f'{jp.name!r} defaults to {tp.default!r}, JAX '
                           f'to {jp.default!r}')
        elif jp.kind in _VAR and not any(p.kind == jp.kind for p in tps):
            out.append(f'{jp} is missing')
    jnames = {p.name for p in jps}
    for tp in tps:
        if tp.kind in _VAR:
            continue
        if tp.name not in jnames and tp.default is inspect.Parameter.empty:
            out.append(f'added {tp.name!r} has no default')
        if tp.name == 'device' and tp.default not in DEVICE_DEFAULTS:
            out.append(f'device defaults to {tp.default!r}, not the card')
    return out


@pytest.mark.parametrize('module', SHARED)
def test_signatures_bind_jax_calls(module):
    """JAX's positional parameters are a prefix of the port's (names and
    defaults; ``device`` defaults to the card), and what the port adds has
    a default."""
    jpub = _public(_import('hicpeaks_tpu', module))
    tpub = _public(_import('hicpeaks_tpu_torch', module))
    found = {}
    for name in sorted(set(jpub) & set(tpub)):
        key = f'{module}.{name}'
        d = departures(jpub[name], tpub[name])
        if key in ALLOWED:
            assert d, f'{key} is allow-listed but now matches JAX'
        elif d:
            found[key] = d
    assert not found, found


def test_allow_list_names_shared_functions():
    """Every allow-listed departure is a function both packages define,
    with its reason."""
    for key, reason in ALLOWED.items():
        module, name = key.rsplit('.', 1)
        assert module in SHARED, key
        assert name in _public(_import('hicpeaks_tpu', module)), key
        assert name in _public(_import('hicpeaks_tpu_torch', module)), key
        assert reason.strip(), key


@pytest.mark.parametrize('module', sorted(_modules(hicpeaks_tpu)))
def test_jax_api_is_ported_or_named(module):
    """Every public function and class method a JAX module defines is in
    the port's module of the same name, defined there or imported into it
    (``ops.score.chunk_hist`` comes from ``ops/cuda_hist.py``), or is in
    :data:`NOT_PORTED`; a JAX module the port lacks is there whole.  A
    stale entry fails."""
    jmod = _import('hicpeaks_tpu', module)
    if module not in SHARED:
        assert module in NOT_PORTED, f'{module} is neither ported nor named'
        assert not any(k.startswith(f'{module}.') for k in NOT_PORTED)
        return
    assert module not in NOT_PORTED, f'{module} is ported but named'
    tmod = _import('hicpeaks_tpu_torch', module)
    missing, stale = [], []
    for name in sorted(_jax_api(jmod)):
        key = f'{module}.{name}'
        if _has(tmod, name):
            if key in NOT_PORTED:
                stale.append(key)
        elif key not in NOT_PORTED:
            missing.append(key)
    assert not missing, f'neither ported nor named: {missing}'
    assert not stale, f'named in NOT_PORTED but ported: {stale}'


def test_not_ported_names_jax_functions():
    """Every entry of :data:`NOT_PORTED` is a JAX module or one of its
    public functions, with its reason."""
    jmods = _modules(hicpeaks_tpu)
    for key, reason in NOT_PORTED.items():
        assert reason.strip(), key
        if key in jmods:
            continue
        module, name = key.rsplit('.', 1)
        assert module in jmods, key
        assert name in _jax_api(_import('hicpeaks_tpu', module)), key


def test_departures_catch_a_shifted_device():
    """The check itself: ``device`` third, before JAX's ``mesh``, or
    without a default, is a departure."""
    def jax_form(bands, cfg, mesh=None, scan_backend='auto'):
        pass

    def shifted(bands, cfg, device=None, mesh=None, scan_backend='auto'):
        pass

    def required(bands, cfg, mesh=None, scan_backend='auto', *, device):
        pass

    def port_form(bands, cfg, mesh=None, scan_backend='auto', *,
                  device=None):
        pass

    assert departures(jax_form, shifted)
    assert departures(jax_form, required)
    assert departures(jax_form, port_form) == []


HCFG = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=1500000)
BCFG = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=1500000)
CALLS = {'call_hiccups': HCFG, 'call_bhfdr': BCFG}
ENGINES = {'hiccups_chrom': HCFG, 'bhfdr_chrom': BCFG}


@pytest.fixture(scope='module')
def uri(tmp_path_factory):
    res = 25000
    sizes, chunks, weights = {}, [], []
    offset = 0
    for c, nb, seed in (('1', 160, 3), ('2', 128, 4)):
        b1, b2, ct, _, bias = synthesize_chrom(n_bins=nb, res=res, seed=seed,
                                               n_loops=8, depth=60.0)
        sizes[c] = nb * res
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        w = np.full(nb, np.nan)
        ok = bias > 0
        w[ok] = 1.0 / bias[ok]
        weights.append(w)
        offset += nb
    u = f'{tmp_path_factory.mktemp("sig") / "two.cool"}::{res}'
    create_cooler_file(u, binnify(sizes, res), chunks,
                       metadata={'onlyIntra': 'True'})
    JCoolerLite(u).write_weights(np.concatenate(weights))
    return u


def _bands(uri, cfg, dtype=np.float64):
    return bands_from_cooler(CoolerLite(uri), '1', cfg.maxapart, cfg.maxww,
                             cfg.ww_min, dtype=dtype,
                             weight_name=cfg.clr_weight_name)


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason='the host has CUDA: the default runs on the card')
@pytest.mark.parametrize('call', sorted(CALLS) + sorted(ENGINES))
def test_jax_call_without_device_asks_for_cuda(uri, call):
    """JAX's plain call, ``call_hiccups(uri, cfg)`` or
    ``hiccups_chrom(bands, cfg)``, asks for the card: on a host without
    CUDA it raises RuntimeError naming CUDA (not TypeError), and nothing
    falls back to the CPU."""
    if call in CALLS:
        fn, arg, cfg = getattr(tapi, call), uri, CALLS[call]
    else:
        fn, cfg = getattr(tengine, call), ENGINES[call]
        arg = _bands(uri, cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        fn(arg, cfg)


def test_resolve_device_default_is_the_card():
    assert tengine.resolve_device('cpu') == torch.device('cpu')
    if torch.cuda.is_available():
        assert tengine.resolve_device().type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            tengine.resolve_device()


@pytest.mark.parametrize('call', sorted(CALLS))
def test_api_mesh_without_device_runs_on_the_mesh(uri, call):
    """With a CPU mesh and no ``device`` the API runs on the mesh's own
    device, and returns the ``device='cpu'`` tables in the same order."""
    fn, cfg = getattr(tapi, call), CALLS[call]
    want = fn(uri, cfg, device='cpu')
    got = fn(uri, cfg, mesh=make_tile_mesh(devices=['cpu'] * 3))
    assert sum(len(t) for t in want.values()) > 0
    assert got == want
    assert [list(t) for t in got.values()] == \
        [list(t) for t in want.values()]


@pytest.mark.parametrize('call', sorted(ENGINES))
def test_engine_mesh_is_the_third_positional(uri, call):
    """``hiccups_chrom(bands, cfg, mesh)``, JAX's positional form, is the
    ``mesh=`` keyword form, and both are the ``device='cpu'`` table."""
    fn, cfg = getattr(tengine, call), ENGINES[call]
    bands = _bands(uri, cfg)
    mesh = make_tile_mesh(devices=['cpu'] * 3)
    by_position = fn(bands, cfg, mesh)
    assert len(by_position) > 0
    assert by_position == fn(bands, cfg, mesh=mesh)
    assert list(by_position) == list(fn(bands, cfg, device='cpu'))


def test_sharded_bands_default_dtype_is_jax_float64(uri):
    """JAX's default dtype, float64, for every slab and vector of a
    single-process call, and the same bands as an explicit float64."""
    want = inspect.signature(jmultihost.sharded_bands_from_cooler) \
        .parameters['dtype'].default
    assert want is np.float64
    assert inspect.signature(tmultihost.sharded_bands_from_cooler) \
        .parameters['dtype'].default is want
    clr, mesh = CoolerLite(uri), make_tile_mesh(devices=['cpu'] * 2)
    args = (clr, '1', BCFG.maxapart, BCFG.maxww, BCFG.ww_min, mesh)
    got = tmultihost.sharded_bands_from_cooler(*args)
    explicit = tmultihost.sharded_bands_from_cooler(*args, dtype=np.float64)
    assert got.raw_spans
    for span, slab in got.raw_spans.items():
        assert slab.dtype == np.float64, span
        np.testing.assert_array_equal(slab, explicit.raw_spans[span])
    for k in ('IR', 'bias', 'w0'):
        assert getattr(got, k).dtype == np.float64, k
        np.testing.assert_array_equal(getattr(got, k), getattr(explicit, k))
