"""The port's stage spans (hicpeaks_tpu_torch/core/spans.py) under
``torch.profiler``: every route's stages nested in one ``hicpeaks.call``
a chromosome call, one ``hicpeaks.sync`` a blocking read, the tables the
untraced call's, no ``RecordFunction`` without a capture, and the prefetch
thread's spans in ``api``'s ``profile_dir`` trace.

Only the port is imported (no JAX): on the CPU the kernels' wrappers run
their plain twins."""
import contextlib
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hicpeaks_tpu_torch import api
from hicpeaks_tpu_torch.core import engine, spans
from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
from hicpeaks_tpu_torch.io.synth import synthetic_cooler
from hicpeaks_tpu_torch.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh

from .test_torch_profile import _write_cooler
from .torch_threads import one_intra_op_thread  # noqa: F401

HCFG = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8, maxapart=2_000_000,
                     min_marginal_peaks=2, min_local_reads=16)
BCFG = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=2_000_000)

# every stage of a one-device call on the fused route
FRONT = {'hicpeaks.call', 'hicpeaks.h2d', 'hicpeaks.sheets', 'hicpeaks.scan',
         'hicpeaks.replay', 'hicpeaks.score', 'hicpeaks.host_complete',
         'hicpeaks.merge', 'hicpeaks.clustering', 'hicpeaks.anchors',
         spans.SYNC}
EXACT = {'hicpeaks.exact_stats'}
# pyHICCUPS merges its (pw, ww) pairs one by one
PAIRS = {'hicpeaks.pair_merge'}
QTAB = {'hicpeaks.qtab64'}
# the batched pyHICCUPS scorer completes on the device (its CPU twin, the
# host's float64 statistics, inside the span)
ON_DEVICE = FRONT - {'hicpeaks.host_complete'} | {'hicpeaks.complete64'}
MESH = 'mesh'    # the route's call on a mesh of two CPU tiles

# route: (caller, the call's keywords, the stages it passes)
ROUTES = {
    'hiccups-fused': ('hiccups', {}, ON_DEVICE | EXACT | PAIRS),
    'hiccups-host-gate': ('hiccups', {'gate': 1}, ON_DEVICE | EXACT | PAIRS),
    'hiccups-dense': ('hiccups', {'bh_backend': 'host'},
                      FRONT | QTAB | PAIRS),
    'hiccups-fallback': ('hiccups', {'fail_audit': (2, 'Y')},
                         FRONT | ON_DEVICE | EXACT | QTAB | PAIRS
                         | {'hicpeaks.dense_fallback'}),
    'hiccups-checkify': ('hiccups', {'check': True},
                         FRONT | EXACT | QTAB | PAIRS),
    'hiccups-mesh': ('hiccups', {MESH: 2},
                     FRONT - {'hicpeaks.h2d'} | EXACT | QTAB | PAIRS),
    'bhfdr-fused': ('bhfdr', {}, FRONT | EXACT),
    'bhfdr-host-gate': ('bhfdr', {'gate': 1}, FRONT | EXACT),
    'bhfdr-dense': ('bhfdr', {'bh_backend': 'host'}, FRONT),
    'bhfdr-mesh': ('bhfdr', {MESH: 2}, FRONT - {'hicpeaks.h2d'} | EXACT),
}

# the reads a host blocks on when its tensors live on a card
READS = {torch.Tensor: ('cpu', 'tolist', 'item', '__bool__', '__int__',
                        '__float__', '__index__'),
         torch: ('nonzero', 'bincount', 'unique_consecutive')}
# the kernels' plain twins, which run here in the kernels' place and not
# on a card
TWINS = ('cuda_hist.py', 'cuda_scan.py', 'scan.py')


@pytest.fixture(scope='module')
def clr(tmp_path_factory):
    path = tmp_path_factory.mktemp('spans') / 'spans.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=300, res=25000, seed=3,
                              n_loops=40, depth=80.0, loop_strength=8.0)
    return CoolerLite(uri)


def _bands(clr):
    return bands_from_cooler(clr, '21', 2_000_000, 8, 3, dtype=np.float32)


@contextlib.contextmanager
def _counted_reads(counter):
    """Count each call of the reads of READS that this thread makes while
    the block runs, outside the kernels' twins."""
    me = threading.get_ident()
    saved = []

    def counting(real):
        def read(*a, **k):
            where = os.path.basename(sys._getframe(1).f_code.co_filename)
            if threading.get_ident() == me and where not in TWINS:
                counter.append(1)
            return real(*a, **k)
        return read
    for owner, names in READS.items():
        for name in names:
            real = getattr(owner, name)
            saved.append((owner, name, real))
            setattr(owner, name, counting(real))
    try:
        yield
    finally:
        for owner, name, real in reversed(saved):
            setattr(owner, name, real)


def _fail_audit(monkeypatch, target):
    """Make the suspect audit of the background ``target`` = (p, kind)
    fail: its device keep thresholds raised far above every count, in the
    host completion and in the device one."""
    real = engine._compact_to_host

    def audited(fetched, *a, **k):
        exact = k.get('exact')
        if exact and fetched.sus is not None and \
                tuple(exact[1:]) == target:
            fetched = fetched._replace(sus=fetched.sus._replace(
                thr=np.asarray(fetched.sus.thr) + 10 ** 6))
        return real(fetched, *a, **k)
    monkeypatch.setattr(engine, '_compact_to_host', audited)
    real_device = engine.complete_on_device

    def audited_device(sh, out, bgs, ctx, sig):
        thr = out.sus.thr.clone()
        for b, (p, _, kind, _) in enumerate(bgs):
            if (p, kind) == target:
                thr[b] += 10 ** 6
        return real_device(sh, out._replace(sus=out.sus._replace(thr=thr)),
                           bgs, ctx, sig)
    monkeypatch.setattr(engine, 'complete_on_device', audited_device)


def _call(clr, caller, kw, monkeypatch):
    """-> a function making the route's call on ``bands``."""
    kw = dict(kw)
    if 'gate' in kw:
        monkeypatch.setattr(engine, '_GATE_LIMIT', kw.pop('gate'))
    if 'fail_audit' in kw:
        _fail_audit(monkeypatch, kw.pop('fail_audit'))
    if MESH in kw:
        kw['mesh'] = make_tile_mesh(devices=['cpu'] * kw.pop(MESH))
    fn, cfg = ((engine.hiccups_chrom, HCFG) if caller == 'hiccups' else
               (engine.bhfdr_chrom, BCFG))
    return lambda bands: fn(bands, cfg, device='cpu', **kw)


def _marks(prof, tmp_path):
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [e for e in events if e.get('ph') == 'X'
            and e.get('cat') == 'user_annotation']


@pytest.mark.parametrize('route', list(ROUTES))
def test_route_stages_nest_in_one_call(clr, route, monkeypatch, tmp_path):
    """Every stage of the route, and no other, inside the call's one
    ``hicpeaks.call``; one ``hicpeaks.sync`` a read; the table == the
    untraced call's."""
    caller, kw, stages = ROUTES[route]
    call = _call(clr, caller, kw, monkeypatch)
    want = call(_bands(clr))
    bands = _bands(clr)
    reads = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with _counted_reads(reads):
            got = call(bands)
    assert len(want) > 0
    assert got == want and list(got) == list(want)
    marks = [e for e in _marks(prof, tmp_path)
             if e['name'].startswith('hicpeaks.')]
    assert {e['name'] for e in marks} == stages
    calls = [e for e in marks if e['name'] == 'hicpeaks.call']
    assert len(calls) == 1
    lo, hi = calls[0]['ts'], calls[0]['ts'] + calls[0]['dur']
    for e in marks:
        assert lo <= e['ts'] and e['ts'] + e['dur'] <= hi, e['name']
    syncs = sum(e['name'] == spans.SYNC for e in marks)
    assert syncs == len(reads) > 0
    fallbacks = sum(e['name'] == 'hicpeaks.dense_fallback' for e in marks)
    assert fallbacks == ('fail_audit' in kw)


@pytest.mark.parametrize('stage', ['hicpeaks.exact_stats', 'hicpeaks.qtab64'])
def test_completion_parts_nest_in_the_completion(clr, stage, tmp_path):
    """The float64 host completion's two parts run inside its span (on
    checkify's route, which completes on the host)."""
    bands = _bands(clr)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.hiccups_chrom(bands, HCFG, device='cpu', check=True)
    marks = _marks(prof, tmp_path)
    outer = [(e['ts'], e['ts'] + e['dur']) for e in marks
             if e['name'] == 'hicpeaks.host_complete']
    inner = [e for e in marks if e['name'] == stage]
    assert inner
    for e in inner:
        assert any(a <= e['ts'] and e['ts'] + e['dur'] <= b
                   for a, b in outer)


@pytest.mark.parametrize('thread', ['caller', 'other'])
def test_span_without_a_capture_is_the_shared_null_context(thread,
                                                           monkeypatch):
    """No capture: ``span`` makes no ``RecordFunction`` on any thread and
    hands back one shared null context; a capture on this thread records
    on it alone, unless it traces every thread."""
    made = []
    real = spans.record_function

    def counted(name):
        made.append(name)
        return real(name)
    monkeypatch.setattr(spans, 'record_function', counted)
    got = []

    def take():
        got.append(spans.span('hicpeaks.call'))
    run = take if thread == 'caller' else \
        (lambda: _on_thread(take))
    run()
    assert got == [spans._NULL] and made == []
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    assert (got[-1] is spans._NULL) == (thread == 'other')
    prof = spans.EveryThread([ProfilerActivity.CPU])
    prof.start()
    try:
        run()
    finally:
        prof.stop()
    assert got[-1] is not spans._NULL
    run()
    assert got[-1] is spans._NULL


def _on_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_every_thread_capture_needs_the_option(monkeypatch):
    """A torch without ``profile_all_threads`` raises, naming it."""
    def old(**k):
        raise TypeError('unexpected keyword argument')
    monkeypatch.setattr(torch._C._profiler, '_ExperimentalConfig', old)
    with pytest.raises(RuntimeError, match='profile_all_threads'):
        spans.EveryThread([ProfilerActivity.CPU])


@pytest.fixture(scope='module')
def api_marks(tmp_path_factory):
    """The host marks of ``api.call_bhfdr``'s ``profile_dir`` trace over
    three chromosomes (the third one's band is built after the capture
    starts: the queue holds one), after checking its tables against the
    untraced call's."""
    root = tmp_path_factory.mktemp('spans_api')
    uri = _write_cooler(root / 'three.cool', (('1', 160, 3), ('2', 120, 4),
                                              ('3', 100, 5)), 25000, None)
    want = api.call_bhfdr(uri, BCFG, device='cpu')
    got = api.call_bhfdr(uri, BCFG, device='cpu',
                         profile_dir=str(root / 'trace'))
    assert got == want
    assert not spans._every_thread
    (path,) = (root / 'trace').glob('*.pt.trace.json')
    with open(path) as f:
        return [e for e in json.load(f)['traceEvents']
                if e.get('ph') == 'X' and e.get('cat') == 'user_annotation']


@pytest.mark.parametrize('name,on', [
    ('hicpeaks.band.read', 'producer'), ('hicpeaks.band.build', 'producer'),
    ('hicpeaks.band.stage', 'producer'), ('hicpeaks.band.wait', 'consumer'),
    ('hicpeaks.call', 'consumer')])
def test_profile_dir_holds_the_prefetch_threads_spans(api_marks, name, on):
    """``api``'s capture traces every thread: the producer's read, build
    and staging spans on a thread other than the consumer's, the wait on
    the queue and the calls on the consumer's."""
    consumer = {e['tid'] for e in api_marks
                if e['name'].startswith('Chrom:')}
    assert len(consumer) == 1
    tids = {e['tid'] for e in api_marks if e['name'] == name}
    assert tids
    assert (tids == consumer) if on == 'consumer' else not tids & consumer
