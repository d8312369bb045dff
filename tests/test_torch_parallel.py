"""The port's tile mesh (hicpeaks_tpu_torch/parallel/tiles.py and the
engines' mesh route) against JAX's mesh on its 8 virtual CPU devices
(tests/conftest.py), on tests/test_sharded.py's synthetic cooler (384 bins
at 25 kb, seed 7): per-tile scans with halos, the summed histogram, IR
from the tiles, both callers' mesh tables, tile counts that do not divide
the band's width, a one-tile mesh, and the row-major merge of the tiles'
compactions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicpeaks_tpu.core import engine as jengine
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.parallel import tiles as jtiles
from hicpeaks_tpu.parallel.mesh import make_tile_mesh as jmesh
from hicpeaks_tpu_torch.core import engine as tengine
from hicpeaks_tpu_torch.core import poolplan
from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
from hicpeaks_tpu_torch.ops import score as tscore
from hicpeaks_tpu_torch.ops.band import bands_from_cooler
from hicpeaks_tpu_torch.parallel import tiles
from hicpeaks_tpu_torch.parallel.mesh import TileMesh, make_tile_mesh

from .torch_threads import one_intra_op_thread  # noqa: F401

HCFG = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=8, maxapart=2000000,
                     min_marginal_peaks=2, min_local_reads=16)
BCFG = BHFDRConfig(pw=1, ww=3, maxww=8, maxapart=2000000)
N_TILES = [8, 5, 1]      # 5 does not divide the 384-column band


def _mesh(n):
    return make_tile_mesh(devices=['cpu'] * n)


@pytest.fixture(scope='module')
def clr(tmp_path_factory):
    path = tmp_path_factory.mktemp('tpar') / 'shard.cool'
    uri, _ = synthetic_cooler(str(path), n_bins=384, res=25000, seed=7,
                              n_loops=25, depth=60.0)
    return CoolerLite(uri)


def _bands(clr, cfg, dtype):
    return bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww, 3,
                             dtype=dtype)


@pytest.fixture(scope='module')
def sheets(clr):
    """pyHICCUPS's float32 sheets on the CPU, its plan and a gate that
    stops the last entry."""
    b = _bands(clr, HCFG, np.float32)
    ops = tengine.bands_to_device(b, 'cpu')
    raw, cband, eband, Bprod, gap_drop, cand = tscore.build_sheets(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        b.ww_min, b.L, 3, HCFG.maxapart // b.res, 3)
    plan = tuple(poolplan.hiccups_pool_plan(HCFG.pw, HCFG.ww, HCFG.maxww))
    allowed = np.ones(len(plan), bool)
    allowed[-1] = False
    return dict(raw=raw, cband=cband, eband=eband, cand=cand, IR=ops['IR'],
                Bprod=Bprod, L=b.L, plan=plan, p_list=(1, 2),
                allowed=allowed)


def _stitch(parts, width):
    return torch.cat([p for p in parts], -1)[..., :width]


@pytest.mark.parametrize('n', N_TILES)
def test_pass_a_counts_equal_jax_and_single_device(sheets, n):
    s = sheets
    mesh = _mesh(n)
    got = tiles.scan_pass_a_sharded(
        tiles.shard_band(s['raw'], mesh), tiles.shard_band(s['cand'], mesh),
        s['plan'], s['p_list'], 16, mesh)
    jm = jmesh(n)
    want = jtiles.scan_pass_a_sharded(
        jtiles.shard_band(jnp.asarray(s['raw'].numpy()), jm),
        jtiles.shard_band(jnp.asarray(s['cand'].numpy()), jm),
        s['plan'], s['p_list'], 16, jm, scan_backend='jnp')
    single = tengine.cuda_scan.scan_pass_a(s['raw'], s['cand'], s['plan'],
                                           s['p_list'], 16)
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), single.numpy())


@pytest.mark.parametrize('n', N_TILES)
def test_pass_b_captures_bit_equal_jax(sheets, n):
    """The tiles' cropped captures, stitched, are bit-equal to JAX's
    sharded captures and to the single-device ones (test_torch_scan.py's
    bar)."""
    s = sheets
    mesh, jm = _mesh(n), jmesh(n)
    allowed = torch.from_numpy(s['allowed'])
    parts = tiles.scan_pass_b_sharded(
        *(tiles.shard_band(s[k], mesh)
          for k in ('raw', 'cband', 'eband', 'cand')),
        allowed, s['plan'], s['p_list'], 16, mesh)
    _, _, want = jtiles.scan_pass_b_sharded(
        *(jtiles.shard_band(jnp.asarray(s[k].numpy()), jm)
          for k in ('raw', 'cband', 'eband', 'cand')),
        jnp.asarray(s['allowed']), s['plan'], s['p_list'], 16, jm,
        scan_backend='jnp')
    single = tengine.cuda_scan.scan_pass_b(
        s['raw'], s['cband'], s['eband'], s['cand'], allowed, s['plan'],
        s['p_list'], 16)
    Lp = s['raw'].shape[1]
    for p in s['p_list']:
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            got = _stitch([o[p][t] for o in parts], Lp).numpy()
            assert got.any()
            np.testing.assert_array_equal(
                got, np.asarray(want[p][t])[:, :Lp], err_msg=f'{p} {name}')
            np.testing.assert_array_equal(got, single[p][t].numpy())


def test_chunk_hist_sharded_equals_jax_rows_from_1(sheets):
    """The per-tile histograms, summed, equal JAX's sharded histogram in
    rows >= 1 (JAX pads its pack into cell (0, 0)) and the single-device
    histogram everywhere."""
    s = sheets
    caps = tengine.cuda_scan.scan_pass_b(
        s['raw'], s['cband'], s['eband'], s['cand'],
        torch.from_numpy(s['allowed']), s['plan'], s['p_list'], 16)
    E, O, _, _, scored, _ = tscore.expected_observed(
        s['raw'], s['cband'], s['IR'], s['Bprod'], caps[1][0], caps[1][1],
        3, s['cand'], s['L'])
    cid, _, valid = tscore.lambda_chunks(E, scored)
    S, C = 128, 1025
    mesh, jm = _mesh(8), jmesh(8)
    got = tiles.chunk_hist_sharded(
        tiles.shard_band(O, mesh), tiles.shard_band(cid[None], mesh),
        tiles.shard_band(valid[None], mesh), S, C, mesh)
    want = np.asarray(jtiles.chunk_hist_sharded(
        *(jtiles.shard_band(jnp.asarray(a.numpy()), jm)
          for a in (O, cid, valid)), S, C, 'jnp', jm))
    oc, cid0 = tscore.chunk_pack(O, cid[None], valid[None], S, C)
    single = tscore.chunk_hist(oc, cid0, S, C)
    assert int(got[1:].sum()) > 0
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])
    np.testing.assert_array_equal(got.numpy(), single.numpy())


@pytest.mark.parametrize('n', N_TILES)
def test_ir_sharded_matches_host_builder(clr, n):
    """IR from the tiles with one psum equals the host builder's in
    float64 to rtol 1e-12, NaN diagonals included (test_sharded.py:
    53-71)."""
    b = _bands(clr, HCFG, np.float64)
    assert b.nanw.any()
    mesh = _mesh(n)
    got = tiles.ir_sharded(tiles.shard_band(torch.from_numpy(b.raw), mesh),
                           b.w0, b.nanw, b.L, b.ww_min, b.num, mesh)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), b.IR, rtol=1e-12,
                               equal_nan=True)


@pytest.fixture(scope='module')
def jax_mesh_tables(clr):
    """JAX's 8-device mesh tables on float64 bands: pyBHFDR, pyHICCUPS
    and pyHICCUPS with IR from the tiles."""
    jm = jmesh(8)
    return {
        'bhfdr': jengine.bhfdr_chrom(_bands(clr, BCFG, np.float64), BCFG,
                                     mesh=jm),
        'hiccups': jengine.hiccups_chrom(_bands(clr, HCFG, np.float64),
                                         HCFG, mesh=jm),
        'hiccups_device_ir': jengine.hiccups_chrom(
            _bands(clr, HCFG, np.float64), HCFG, mesh=jm,
            ir_backend='device')}


@pytest.mark.parametrize('n', N_TILES)
def test_bhfdr_mesh_table_equals_jax_mesh(clr, jax_mesh_tables, n):
    want = jax_mesh_tables['bhfdr']
    got = tengine.bhfdr_chrom(_bands(clr, BCFG, np.float64), BCFG,
                              mesh=_mesh(n))
    assert len(want) > 0
    assert got == want and list(got) == list(want)


@pytest.mark.parametrize('n', N_TILES)
@pytest.mark.parametrize('ir_backend,rtol', [('host', 1e-12),
                                             ('device', 1e-9)])
def test_hiccups_mesh_table_matches_jax_mesh(clr, jax_mesh_tables, n,
                                             ir_backend, rtol):
    want = jax_mesh_tables['hiccups' if ir_backend == 'host'
                           else 'hiccups_device_ir']
    got = tengine.hiccups_chrom(_bands(clr, HCFG, np.float64), HCFG,
                                mesh=_mesh(n), ir_backend=ir_backend)
    assert len(want) > 0 and set(got) == set(want)
    for k in want:
        assert got[k][:3] == want[k][:3]
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), rtol=rtol)


def test_merge_rowmajor_orders_tiles_by_diagonal_then_column():
    """Two tiles (columns 0-3 and 4-7) whose compactions hold pixels on
    the same diagonals: tile order is not row-major, the merge is."""
    mesh = TileMesh(['cpu', 'cpu'])
    d0, x0 = np.array([1, 2, 5]), np.array([3, 0, 1])
    d1, x1 = np.array([1, 2, 2]), np.array([0, 1, 3])
    v0, v1 = np.array([10., 20., 30.]), np.array([40., 50., 60.])
    (d, x, v), = tiles.merge_rowmajor([(0, [(d0, x0, v0)]),
                                       (4, [(d1, x1, v1)])], mesh)
    assert list(zip(d, x)) == [(1, 3), (1, 4), (2, 0), (2, 5), (2, 7),
                               (5, 1)]
    assert list(v) == [10., 40., 20., 50., 60., 30.]


def test_compaction_merge_is_single_device_order(clr):
    """pyBHFDR's kept pixels from 8 tiles, merged, come in the
    single-device compaction's order, with some diagonal's pixels kept in
    two tiles (so tile order alone would break it)."""
    b = _bands(clr, BCFG, np.float64)
    plan = tuple(poolplan.bhfdr_pool_plan(BCFG.pw, BCFG.ww, BCFG.maxww))
    total = b.candidate_total(BCFG.ww, BCFG.maxapart // b.res)
    mesh = _mesh(8)

    def replay(c):
        return poolplan.emulate_freeze_bhfdr(plan, c, total)

    args = (plan, (BCFG.pw,), 16, BCFG.ww, BCFG.maxapart // b.res, BCFG.ww)
    route = tengine.resolve_route('auto', 'auto', False, total, mesh=mesh)
    ts, outs_t, _ = tengine._mesh_front(b, mesh, *args, route, replay,
                                        'host')
    got = tengine._bhfdr_tiles(ts, outs_t, BCFG.pw, BCFG.ww, BCFG.siglevel,
                               exact=None)
    # the same route on one device: the host gate, the global-BH scorer
    sh, outs, _ = tengine._scan_front(
        tengine.bands_to_device(b, 'cpu'), b, *args, route, replay, None)
    want = tengine._score_one(sh, outs[1][0], outs[1][1], BCFG.ww,
                              BCFG.siglevel, route, chunked=False)
    pairs = list(zip(got['x'].tolist(), got['y'].tolist()))
    assert pairs == list(zip(want['x'].tolist(), want['y'].tolist()))
    tiles_of_d = {}
    for x, y in pairs:
        tiles_of_d.setdefault(y - x, set()).add(x // ts.T)
    assert max(len(t) for t in tiles_of_d.values()) >= 2


def test_mesh_type_and_halo_checks(sheets):
    """A mesh that is not a TileMesh is a TypeError; tiles narrower than
    the halo are refused; the halo covers the kernels' reach."""
    s = sheets
    with pytest.raises(TypeError, match='TileMesh'):
        tengine.bhfdr_chrom(None, BCFG, mesh=jmesh(2))
    assert tiles.halo_width(s['plan']) == 16 >= \
        tengine.cuda_scan.max_ring(s['plan'])
    mesh = _mesh(32)           # 12 columns a tile, under the 16 of the halo
    with pytest.raises(ValueError, match='narrower'):
        tiles.scan_pass_a_sharded(tiles.shard_band(s['raw'], mesh),
                                  tiles.shard_band(s['cand'], mesh),
                                  s['plan'], s['p_list'], 16, mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            make_tile_mesh(2)        # a mesh of cards never falls back
