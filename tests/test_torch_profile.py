"""The port's ``profile_dir`` capture (hicpeaks_tpu_torch/api.py): a
``torch.profiler`` trace of the genome loop, one Chrome-trace file a
process, the tables unchanged.

Only the port is imported: the test marked ``cuda`` also runs on a GPU
host, which has no JAX (``python -m pytest --noconftest
tests/test_torch_profile.py``)."""
import glob
import json
import os
import socket

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity

from hicpeaks_tpu_torch import api
from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                              create_cooler_file)
from hicpeaks_tpu_torch.io.synth import synthesize_chrom
from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh

from .torch_threads import one_intra_op_thread  # noqa: F401

CFG = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=1500000)
BCFG = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=1500000)
CALLS = {'call_hiccups': CFG, 'call_bhfdr': BCFG}
# the hand-written kernels as a trace names them, and the fused route's
# launches of each in one chromosome call (PERF.md section 6)
KERNELS = ('scan_pass_a_kernel', 'scan_pass_b_kernel', 'chunk_hist_kernel')
FUSED = {'call_hiccups': (1, 1, 1), 'call_bhfdr': (1, 1, 0)}


def _write_cooler(path, chroms, res, balance):
    """A cooler of ``chroms`` ((name, bins, seed), ...) synthesized at
    ``res``, with weights from the synthesis's bias, or balanced by
    ``balance(clr)``."""
    sizes, chunks, weights, offset = {}, [], [], 0
    for c, nb, seed in chroms:
        b1, b2, ct, _, bias = synthesize_chrom(n_bins=nb, res=res, seed=seed,
                                               n_loops=nb // 12, depth=60.0)
        sizes[c] = nb * res
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        w = np.full(nb, np.nan)
        w[bias > 0] = 1.0 / bias[bias > 0]
        weights.append(w)
        offset += nb
    uri = f'{path}::{res}'
    create_cooler_file(uri, binnify(sizes, res), chunks,
                       metadata={'onlyIntra': 'True'})
    if balance is None:
        CoolerLite(uri).write_weights(np.concatenate(weights))
    else:
        balance(CoolerLite(uri))
    return uri


@pytest.fixture(scope='module')
def uri(tmp_path_factory):
    return _write_cooler(tmp_path_factory.mktemp('prof') / 'two.cool',
                         (('1', 160, 3), ('2', 120, 4)), 25000, None)


def _traces(d):
    return sorted(glob.glob(os.path.join(str(d), '*.pt.trace.json')))


@pytest.mark.parametrize('call', list(CALLS))
def test_profile_dir_writes_one_trace_and_the_same_tables(uri, tmp_path,
                                                          call):
    """One Chrome trace named after the caller, with the host's aten ops,
    and the tables == the untraced call's."""
    fn, cfg = getattr(api, call), CALLS[call]
    want = fn(uri, cfg, device='cpu')
    got = fn(uri, cfg, device='cpu', profile_dir=str(tmp_path))
    assert sum(len(t) for t in want.values()) > 0
    assert got == want
    assert [list(t) for t in got.values()] == \
        [list(t) for t in want.values()]
    files = _traces(tmp_path)
    assert len(files) == 1 and os.listdir(tmp_path) == \
        [os.path.basename(files[0])]
    assert os.path.basename(files[0]).startswith(
        call.split('_')[1] + f'.{socket.gethostname()}.rank0.')
    with open(files[0]) as f:
        events = json.load(f)['traceEvents']
    assert isinstance(events, list)
    assert any(str(e.get('name', '')).startswith('aten::') for e in events)
    assert api.count_kernel_events(files[0]) == 0


def test_missing_nested_profile_dir_is_created(uri, tmp_path):
    d = tmp_path / 'a' / 'b' / 'c'
    api.call_bhfdr(uri, BCFG, chroms=('2',), device='cpu', profile_dir=str(d))
    assert len(_traces(d)) == 1


def test_profile_dir_on_a_mesh(uri, tmp_path):
    """A 2-tile CPU mesh traces on the host alone, with its tables
    unchanged."""
    mesh = make_tile_mesh(devices=['cpu'] * 2)
    want = api.call_hiccups(uri, CFG, chroms=('1',), mesh=mesh, device='cpu')
    got = api.call_hiccups(uri, CFG, chroms=('1',), mesh=mesh, device='cpu',
                           profile_dir=str(tmp_path))
    assert got == want
    assert len(_traces(tmp_path)) == 1


def test_trace_file_names_differ_by_rank():
    names = [api.trace_file_name('bhfdr', r, host='node7', stamp_ms=1700)
             for r in (0, 1)]
    assert names == ['bhfdr.node7.rank0.1700.pt.trace.json',
                     'bhfdr.node7.rank1.1700.pt.trace.json']
    name = api.trace_file_name('hiccups', 0)
    assert name.startswith(f'hiccups.{socket.gethostname()}.rank0.')
    assert name.endswith('.pt.trace.json')


@pytest.mark.parametrize('device,mesh_devices,cuda', [
    ('cpu', None, False), ('cuda', None, True), ('cpu', ['cpu', 'cuda:0'],
                                                 True)])
def test_trace_activities(device, mesh_devices, cuda):
    """The card is traced when the device or any tile of the mesh is
    CUDA (no card is needed to name one)."""
    from hicpeaks_tpu_torch.parallel.mesh import TileMesh
    mesh = TileMesh(mesh_devices) if mesh_devices else None
    want = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    assert api.trace_activities(torch.device(device), mesh) == want


@pytest.mark.parametrize('text,n', [
    ('{"ph":"X","cat":"kernel","name":"k","ts":1,"dur":2},\n'
     '{"ph":"X","cat":"gpu_memcpy","name":"Memcpy HtoD","ts":4,"dur":1},\n',
     1),
    ('  {\n    "ph": "X", "cat": "kernel", "name": "void k<1>(int)",\n'
     '  },\n  {\n    "ph": "X", "cat": "kernel", "name": "k2",\n  }\n', 2),
    ('{"ph":"X","cat":"cpu_op","name":"aten::add","ts":1,"dur":2}\n', 0)])
def test_count_kernel_events(tmp_path, text, n):
    """Kernel events in both writers' layouts (torch's one line an event,
    kineto's several), and none among host ops and copies."""
    path = tmp_path / 't.json'
    path.write_text(text)
    assert api.count_kernel_events(str(path)) == n


def test_capture_of_the_card_without_kernels_raises(uri, tmp_path,
                                                    monkeypatch):
    """A capture that should trace the card and holds no CUDA kernel (the
    card untraced, as without CUPTI) raises once its file is written."""
    monkeypatch.setattr(api, 'trace_activities', lambda device, mesh: [
        ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with pytest.raises(RuntimeError, match='no CUDA kernel'):
        api.call_bhfdr(uri, BCFG, chroms=('2',), device='cpu',
                       profile_dir=str(tmp_path))
    assert len(_traces(tmp_path)) == 1


def test_failed_run_leaves_its_trace(uri, tmp_path, monkeypatch):
    """The capture stops in the loop's ``finally``: a run that fails
    still writes its trace, and the failure is the run's."""
    def boom(*a, **k):
        raise OSError('disk gone')

    monkeypatch.setattr(api, 'bands_from_cooler', boom)
    with pytest.raises(OSError, match='disk gone'):
        api.call_hiccups(uri, CFG, device='cpu', profile_dir=str(tmp_path))
    assert len(_traces(tmp_path)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize('call', list(FUSED))
def test_card_trace_names_the_kernels(tmp_path, call):
    """On the card, the trace of a chr1-sized call (L = 24,900 at 10 kb)
    holds each hand-written kernel as often as the fused route launches
    it, and the table is the untraced one."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernels have no CPU mode')
    from hicpeaks_tpu_torch.ops import ice
    uri = _write_cooler(tmp_path / 'chr1.cool', (('1', 24900, 42),), 10000,
                        lambda clr: ice.balance(clr, device='cuda'))
    fn, cfg = getattr(api, call), (HiccupsConfig() if call == 'call_hiccups'
                                   else BHFDRConfig())
    want = fn(uri, cfg, device='cuda')
    got = fn(uri, cfg, device='cuda', profile_dir=str(tmp_path / 'trace'))
    assert got == want
    files = _traces(tmp_path / 'trace')
    assert len(files) == 1
    with open(files[0]) as f:
        names = [e['name'] for e in json.load(f)['traceEvents']
                 if e.get('cat') == 'kernel']
    assert tuple(sum(k in n for n in names) for k in KERNELS) == FUSED[call]


@pytest.mark.cuda
@pytest.mark.parametrize('call', list(FUSED))
def test_card_trace_shows_the_staged_copies(tmp_path, call):
    """On the card the prefetch thread stages every chromosome: each slab
    after the first goes out as a pinned copy, on a stream none of the
    kernels runs on, and the tables == the engine's on unstaged bands."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA kernels have no CPU mode')
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler
    uri = _write_cooler(tmp_path / 'three.cool', (('1', 1600, 3),
                                                  ('2', 1400, 4),
                                                  ('3', 1200, 5)), 10000,
                        None)
    fn, cfg = getattr(api, call), CALLS[call]
    staged = engine.stage_chrom_arrays.staged
    got = fn(uri, cfg, device='cuda', profile_dir=str(tmp_path / 'trace'))
    assert engine.stage_chrom_arrays.staged - staged == 3
    caller = engine.hiccups_chrom if call == 'call_hiccups' \
        else engine.bhfdr_chrom
    slabs = {}
    for c in ('1', '2', '3'):
        bands = bands_from_cooler(CoolerLite(uri), c, cfg.maxapart,
                                  cfg.maxww, cfg.ww_min, dtype=np.float32,
                                  weight_name=cfg.clr_weight_name)
        slabs[c] = bands.raw.nbytes
        assert got[c] == caller(bands, cfg, device='cuda'), c
    with open(_traces(tmp_path / 'trace')[0]) as f:
        events = json.load(f)['traceEvents']
    kernel_streams = {e['args']['stream'] for e in events
                      if e.get('cat') == 'kernel'}
    copies = [e for e in events if e.get('cat') == 'gpu_memcpy'
              and 'HtoD' in e['name']
              and int(e['args']['bytes']) in (slabs['2'], slabs['3'])]
    assert [e['name'] for e in copies] == \
        ['Memcpy HtoD (Pinned -> Device)'] * 2
    assert not {e['args']['stream'] for e in copies} & kernel_streams
