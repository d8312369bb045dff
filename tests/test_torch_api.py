"""The port's genome API (hicpeaks_tpu_torch/api.py) against the JAX API
for both callers, and its per-chromosome checkpoints and resume."""
import os

import numpy as np
import pytest

from hicpeaks_tpu import api as japi
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu.io.coolerlite import CoolerLite, binnify, create_cooler_file
from hicpeaks_tpu.io.synth import synthesize_chrom
from hicpeaks_tpu_torch import api as tapi
from hicpeaks_tpu_torch.core import engine as tengine

from .torch_threads import one_intra_op_thread  # noqa: F401

CFG = HiccupsConfig(pw=(1,), ww=(3,), maxww=8, maxapart=1500000)
BCFG = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=1500000)


@pytest.fixture(scope='module')
def uri(tmp_path_factory):
    res = 25000
    sizes, chunks, weights = {}, [], []
    offset = 0
    for c, nb, seed in (('1', 220, 3), ('2', 180, 4)):
        b1, b2, ct, _, bias = synthesize_chrom(n_bins=nb, res=res, seed=seed,
                                               n_loops=10, depth=60.0)
        sizes[c] = nb * res
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        w = np.full(nb, np.nan)
        ok = bias > 0
        w[ok] = 1.0 / bias[ok]
        weights.append(w)
        offset += nb
    u = f'{tmp_path_factory.mktemp("api") / "two.cool"}::{res}'
    create_cooler_file(u, binnify(sizes, res), chunks,
                       metadata={'onlyIntra': 'True'})
    CoolerLite(u).write_weights(np.concatenate(weights))
    return u


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_call_hiccups_matches_jax_api(uri, dtype):
    want = japi.call_hiccups(uri, CFG, dtype=dtype)
    got = tapi.call_hiccups(uri, CFG, device='cpu', dtype=dtype)
    assert set(got) == set(want) == {'1', '2'}
    assert sum(len(t) for t in want.values()) > 0
    for chrom in want:
        assert set(got[chrom]) == set(want[chrom])
        for k, v in want[chrom].items():
            assert tuple(got[chrom][k][:3]) == tuple(v[:3])
            np.testing.assert_allclose(got[chrom][k][3:], v[3:], rtol=1e-12,
                                       atol=1e-300)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_call_bhfdr_matches_jax_api(uri, dtype):
    want = japi.call_bhfdr(uri, BCFG, dtype=dtype)
    got = tapi.call_bhfdr(uri, BCFG, device='cpu', dtype=dtype)
    assert set(got) == set(want) == {'1', '2'}
    assert sum(len(t) for t in want.values()) > 0
    for chrom in want:
        assert list(got[chrom]) == list(want[chrom])
        for k, v in want[chrom].items():
            assert tuple(got[chrom][k][:3]) == tuple(v[:3])
            np.testing.assert_allclose(got[chrom][k][3:], v[3:], rtol=1e-12,
                                       atol=1e-300)


def test_bhfdr_checkpoint_resume(uri, tmp_path, monkeypatch):
    """pyBHFDR checkpoints carry their own prefix: a resumed bhfdr run reads
    them, and a hiccups run in the same directory does not."""
    ck = str(tmp_path / 'ckpt')
    first = tapi.call_bhfdr(uri, BCFG, device='cpu', checkpoint_dir=ck)
    assert sorted(os.listdir(ck)) == ['bhfdr.1.json', 'bhfdr.2.json']

    def no_engine(*a, **k):
        raise AssertionError('resumed run recomputed a chromosome')

    monkeypatch.setattr(tengine, 'bhfdr_chrom', no_engine)
    assert tapi.call_bhfdr(uri, BCFG, device='cpu', checkpoint_dir=ck) \
        == first
    tapi.call_hiccups(uri, CFG, device='cpu', checkpoint_dir=ck,
                      chroms=('2',))
    assert os.path.exists(os.path.join(ck, 'hiccups.2.json'))


def test_checkpoint_resume(uri, tmp_path, monkeypatch):
    ck = str(tmp_path / 'ckpt')
    first = tapi.call_hiccups(uri, CFG, device='cpu', checkpoint_dir=ck)
    for c in ('1', '2'):
        assert os.path.exists(os.path.join(ck, f'hiccups.{c}.json'))

    # a resumed run reads every chromosome from disk: the engine must not run
    def no_engine(*a, **k):
        raise AssertionError('resumed run recomputed a chromosome')

    monkeypatch.setattr(tengine, 'hiccups_chrom', no_engine)
    second = tapi.call_hiccups(uri, CFG, device='cpu', checkpoint_dir=ck)
    assert second == first


def test_loader_failure_propagates(uri, monkeypatch):
    """A band-build failure on the prefetch thread surfaces as the run's
    exception, and the thread exits."""
    import threading

    def boom(*a, **k):
        raise OSError('disk gone')

    monkeypatch.setattr(tapi, 'bands_from_cooler', boom)
    with pytest.raises(OSError, match='disk gone'):
        tapi.call_hiccups(uri, CFG, device='cpu')
    assert not any(t.name == 'hiccups-band-loader' and t.is_alive()
                   for t in threading.enumerate())


def test_jax_positional_order_is_accepted(uri):
    """JAX's order after ``chroms``: mesh, scan_backend, checkpoint_dir,
    dtype, profile_dir, shape_bucket, bh_backend, check, row_bucket,
    max_count_floor; ``device`` stays keyword-only."""
    want = tapi.call_bhfdr(uri, BCFG, device='cpu', dtype=np.float64)
    got = tapi.call_bhfdr(uri, BCFG, ('#', 'X'), None, 'auto', None,
                          np.float64, None, 4096, 'auto', False, 8, None,
                          device='cpu')
    assert got == want
    with pytest.raises(TypeError):
        tapi.call_hiccups(uri, CFG, ('#', 'X'), None, 'auto', None,
                          np.float64, None, 4096, 'auto', False, 8, None,
                          'cpu')


@pytest.mark.parametrize('call', ['call_hiccups', 'call_bhfdr'])
def test_mesh_tables_equal_one_device(uri, call):
    """A mesh that is not a TileMesh raises TypeError, and a 3-tile CPU
    mesh returns the single-device tables, in the same order."""
    from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh
    with pytest.raises(TypeError, match='TileMesh'):
        getattr(tapi, call)(uri, mesh=object(), device='cpu')
    cfg = CFG if call == 'call_hiccups' else BCFG
    want = getattr(tapi, call)(uri, cfg, device='cpu')
    got = getattr(tapi, call)(uri, cfg, mesh=make_tile_mesh(
        devices=['cpu'] * 3), device='cpu')
    assert sum(len(t) for t in want.values()) > 0
    assert got == want
    assert [list(t) for t in got.values()] == \
        [list(t) for t in want.values()]


def test_bucket_arguments_are_logged_without_effect(uri, caplog, tmp_path):
    """The XLA bucket arguments are logged as having no effect;
    ``profile_dir`` has one (a trace, test_torch_profile.py) and is not."""
    want = tapi.call_hiccups(uri, CFG, chroms=('2',), device='cpu')
    with caplog.at_level('INFO', logger=tapi.__name__):
        got = tapi.call_hiccups(uri, CFG, chroms=('2',), device='cpu',
                                profile_dir=str(tmp_path), shape_bucket=512,
                                row_bucket=16, max_count_floor=4096)
    assert got == want
    said = [r.getMessage() for r in caplog.records
            if 'has no effect' in r.getMessage()]
    assert [s.split('=')[0] for s in said] == [
        'shape_bucket', 'row_bucket', 'max_count_floor']
