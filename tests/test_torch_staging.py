"""The prefetch thread's host-to-device staging on the port
(``core/engine.stage_chrom_arrays`` and its pickup, ``api._run``'s
producer) against the unstaged call and the JAX package's staging, on the
CPU.  On a card the copies go through pinned memory on a copy stream
(``test_torch_kernels.py``, ``test_torch_profile.py`` and
``chip_smoke.py`` phase 13 hold that there)."""
import logging
import threading

import numpy as np
import pytest
import torch

from hicpeaks_tpu import api as japi
from hicpeaks_tpu.core import engine as jengine
from hicpeaks_tpu.core.config import BHFDRConfig as JBHFDRConfig
from hicpeaks_tpu.core.config import HiccupsConfig as JHiccupsConfig
from hicpeaks_tpu.io.coolerlite import CoolerLite as JCoolerLite
from hicpeaks_tpu.io.coolerlite import binnify, create_cooler_file
from hicpeaks_tpu.io.synth import synthesize_chrom
from hicpeaks_tpu.ops.band import bands_from_cooler as jbands_from_cooler
from hicpeaks_tpu_torch import api as tapi
from hicpeaks_tpu_torch.core import engine as tengine
from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
from hicpeaks_tpu_torch.ops import score as score_ops
from hicpeaks_tpu_torch.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh

from .torch_threads import one_intra_op_thread  # noqa: F401

SETTINGS = dict(maxww=8, maxapart=1500000)
CALLERS = {
    'hiccups': (HiccupsConfig(pw=(1,), ww=(3,), **SETTINGS),
                JHiccupsConfig(pw=(1,), ww=(3,), **SETTINGS)),
    'bhfdr': (BHFDRConfig(pw=1, ww=3, **SETTINGS),
              JBHFDRConfig(pw=1, ww=3, **SETTINGS)),
}
CHROMS = (('1', 160, 3), ('2', 128, 4), ('3', 96, 5))


@pytest.fixture(scope='module')
def uri(tmp_path_factory):
    res = 25000
    sizes, chunks, weights = {}, [], []
    offset = 0
    for c, nb, seed in CHROMS:
        b1, b2, ct, _, bias = synthesize_chrom(n_bins=nb, res=res, seed=seed,
                                               n_loops=8, depth=60.0)
        sizes[c] = nb * res
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        w = np.full(nb, np.nan)
        w[bias > 0] = 1.0 / bias[bias > 0]
        weights.append(w)
        offset += nb
    u = f'{tmp_path_factory.mktemp("staging") / "three.cool"}::{res}'
    create_cooler_file(u, binnify(sizes, res), chunks,
                       metadata={'onlyIntra': 'True'})
    JCoolerLite(u).write_weights(np.concatenate(weights))
    return u


def _bands(uri, cfg, chrom='1'):
    return bands_from_cooler(CoolerLite(uri), chrom, cfg.maxapart, cfg.maxww,
                             cfg.ww_min, dtype=np.float64,
                             weight_name=cfg.clr_weight_name)


def _engine(caller):
    return (getattr(tengine, f'{caller}_chrom'),
            getattr(jengine, f'{caller}_chrom'))


def _assert_tables_equal(got, want):
    """The same loci in the same order, the geometry equal and the
    statistics within 1e-12 relative (the port's bar against JAX on
    float64 bands, test_torch_engine.py)."""
    assert list(got) == list(want)
    for k, v in want.items():
        assert tuple(got[k][:3]) == tuple(v[:3]), k
        np.testing.assert_allclose(got[k][3:], v[3:], rtol=1e-12,
                                   atol=1e-300)


@pytest.mark.parametrize('caller', sorted(CALLERS))
def test_staged_call_equals_unstaged_and_jax_staged(uri, caller):
    """``stage_chrom_arrays(bands)`` then the engine: the table == the
    unstaged call's, and JAX's engine after JAX's own
    ``stage_chrom_arrays(bands)`` on the same cooler gives it too."""
    cfg, jcfg = CALLERS[caller]
    fn, jfn = _engine(caller)
    want = fn(_bands(uri, cfg), cfg, device='cpu')
    bands = _bands(uri, cfg)
    tengine.stage_chrom_arrays(bands, device='cpu')
    got = fn(bands, cfg, device='cpu')
    assert len(want) > 0
    assert got == want
    assert list(got) == list(want)
    # the JAX API's lane padding, so the two tests share JAX's executables
    jbands = jbands_from_cooler(JCoolerLite(uri), '1', jcfg.maxapart,
                                jcfg.maxww, jcfg.ww_min, dtype=np.float64,
                                weight_name=jcfg.clr_weight_name,
                                lane_pad=4096)
    jengine.stage_chrom_arrays(jbands)
    _assert_tables_equal(got, jfn(jbands, jcfg))


def test_staged_record_holds_the_operands(uri):
    """The CPU record: the five operands with the numpy dtypes kept, the
    device, no event; one count a staged chromosome."""
    cfg = CALLERS['hiccups'][0]
    bands = _bands(uri, cfg)
    before = tengine.stage_chrom_arrays.staged
    tengine.stage_chrom_arrays(bands, device='cpu')
    assert tengine.stage_chrom_arrays.staged == before + 1
    staged = bands._staged
    assert staged.device == torch.device('cpu') and staged.event is None
    assert sorted(staged.tensors) == sorted(('raw', 'w0', 'bias', 'IR',
                                             'gap'))
    for k, t in staged.tensors.items():
        np.testing.assert_array_equal(t.numpy(), getattr(bands, k))
        assert t.numpy().dtype == getattr(bands, k).dtype, k


@pytest.mark.parametrize('caller', sorted(CALLERS))
def test_pickup_takes_the_staged_tensors(uri, caller, monkeypatch):
    """The call's sheets are built from the staged tensors themselves,
    with no copy; a retry takes them again."""
    cfg = CALLERS[caller][0]
    fn = _engine(caller)[0]
    bands = _bands(uri, cfg)
    tengine.stage_chrom_arrays(bands, device='cpu')
    copies, raws = [], []
    real_build = score_ops.build_sheets

    def build(raw, *a, **k):
        raws.append(raw)
        return real_build(raw, *a, **k)

    monkeypatch.setattr(tengine, 'bands_to_device',
                        lambda *a: copies.append(a) or {})
    monkeypatch.setattr(score_ops, 'build_sheets', build)
    first = fn(bands, cfg, device='cpu')
    assert fn(bands, cfg, device='cpu') == first
    assert copies == []
    assert len(raws) == 2
    assert all(r is bands._staged.tensors['raw'] for r in raws)


@pytest.mark.parametrize('caller', sorted(CALLERS))
def test_pickup_ignores_another_devices_staging(uri, caller, monkeypatch):
    """Tensors staged for another device are left alone: the call copies
    the bands to its own device and gives the unstaged table."""
    cfg = CALLERS[caller][0]
    fn = _engine(caller)[0]
    want = fn(_bands(uri, cfg), cfg, device='cpu')
    bands = _bands(uri, cfg)
    tengine.stage_chrom_arrays(bands, device='meta')
    assert bands._staged.tensors['raw'].device.type == 'meta'
    copies = []
    real_copy = tengine.bands_to_device

    def copy(b, device):
        copies.append(device)
        return real_copy(b, device)

    monkeypatch.setattr(tengine, 'bands_to_device', copy)
    assert fn(bands, cfg, device='cpu') == want
    assert copies == [torch.device('cpu')]


@pytest.mark.parametrize('call', ['call_hiccups', 'call_bhfdr'])
def test_api_stages_every_called_chromosome(uri, call, monkeypatch):
    """The producer thread stages each chromosome it builds, once, and the
    consumer copies nothing itself."""
    cfg = CALLERS[call.split('_')[1]][0]
    copied_by = []
    real_copy = tengine.bands_to_device

    def copy(b, device):
        copied_by.append(threading.current_thread().name)
        return real_copy(b, device)

    monkeypatch.setattr(tengine, 'bands_to_device', copy)
    before = tengine.stage_chrom_arrays.staged
    tables = getattr(tapi, call)(uri, cfg, device='cpu')
    assert sorted(tables) == ['1', '2', '3']
    assert tengine.stage_chrom_arrays.staged - before == 3
    loader = f'{call.split("_")[1]}-band-loader'
    assert copied_by == [loader] * 3


@pytest.mark.parametrize('call', ['call_hiccups', 'call_bhfdr'])
def test_api_stages_nothing_on_a_mesh(uri, call):
    """A mesh copies in its tiles' route, as JAX's ``mesh is None`` guard
    says: nothing is staged, and the tables are one device's."""
    fn, cfg = getattr(tapi, call), CALLERS[call.split('_')[1]][0]
    want = fn(uri, cfg, device='cpu')
    before = tengine.stage_chrom_arrays.staged
    got = fn(uri, cfg, mesh=make_tile_mesh(devices=['cpu'] * 2))
    assert tengine.stage_chrom_arrays.staged == before
    assert got == want


def test_api_stages_no_resumed_chromosome(uri, tmp_path):
    """Chromosomes resumed from a checkpoint are neither built nor
    staged."""
    cfg = CALLERS['bhfdr'][0]
    ck = str(tmp_path / 'ckpt')
    tapi.call_bhfdr(uri, cfg, chroms=('2',), device='cpu',
                    checkpoint_dir=ck)
    before = tengine.stage_chrom_arrays.staged
    tables = tapi.call_bhfdr(uri, cfg, device='cpu', checkpoint_dir=ck)
    assert sorted(tables) == ['1', '2', '3']
    assert tengine.stage_chrom_arrays.staged - before == 2


@pytest.mark.parametrize('call', ['call_hiccups', 'call_bhfdr'])
def test_staging_failure_is_logged_and_copied(uri, call, monkeypatch,
                                              caplog):
    """A staging failure is logged with its chromosome, the call copies
    the bands itself, and the tables still equal the JAX API's."""
    cfg, jcfg = CALLERS[call.split('_')[1]]
    want = getattr(japi, call)(uri, jcfg, dtype=np.float64)

    def fail(bands, *, device=None):
        raise RuntimeError('pinned allocation failed')

    monkeypatch.setattr(tengine, 'stage_chrom_arrays', fail)
    with caplog.at_level(logging.ERROR, logger=tapi.__name__):
        got = getattr(tapi, call)(uri, cfg, device='cpu', dtype=np.float64)
    said = [r for r in caplog.records if 'staging' in r.getMessage()]
    assert [r.getMessage().split(',')[0] for r in said] == \
        ['Chrom:1', 'Chrom:2', 'Chrom:3']
    assert all(r.exc_info and 'pinned allocation failed' in str(
        r.exc_info[1]) for r in said)
    assert sorted(got) == sorted(want) == ['1', '2', '3']
    assert sum(len(t) for t in want.values()) > 0
    for chrom in want:
        _assert_tables_equal(got[chrom], want[chrom])
