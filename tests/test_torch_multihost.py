"""Two torch.distributed processes on the CPU (gloo over localhost), the
port's counterpart of tests/test_multihost.py: chromosome
data-parallelism with and without a local 2-tile mesh, per-process
ingestion of a global 2 x 2-tile mesh (a full-chromosome read raises), the
engines and the API on that global mesh, and the pyBHFDR CLI in two
processes, without a mesh and with ``--mesh-devices 2`` (a global mesh,
one CPU tile a process, as JAX's ``make_tile_mesh(2)`` takes the group's
first two devices).  Every case is held against JAX's single-process result,
computed in the test process.

The two workers are this file run as a script (``__main__`` below): they
run every case once, in one process group, and import nothing of JAX or of
the JAX package; the test functions import JAX only inside their bodies.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

if __name__ != '__main__':    # the workers run this file as a script
    from .torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 25000
BCFG = dict(pw=1, ww=3, maxww=6, maxapart=1_000_000)
HCFG = dict(pw=(1,), ww=(3,), maxww=6, maxapart=1_000_000,
            min_marginal_peaks=2, min_local_reads=16)
BHFDR_ARGV = ['--pw', '1', '--ww', '3', '--maxww', '6', '--maxapart',
              '1000000']
CLI_CASES = {'chrom_dp': [], 'global_mesh': ['--mesh-devices', '2']}


def _payload(tables):
    """{name: {'x,y': [stats]}}, a JSON-safe table set."""
    return {c: {','.join(map(str, k)): list(map(float, v))
                for k, v in t.items()} for c, t in tables.items()}


def _keyed(payload):
    return {c: {tuple(int(float(x)) for x in k.split(',')): tuple(v)
                for k, v in t.items()} for c, t in payload.items()}


def _worker(uri, out_dir, cli_port):
    """Every case in one process group, in the same order on each
    process; writes worker.<rank>.json and the CLI's bedpe files.  The
    CLI leaves the group when it is done, so its second run joins a new
    group on ``cli_port``."""
    from hicpeaks_tpu_torch import api
    from hicpeaks_tpu_torch.cli import peakcall
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.parallel import launch, multihost

    assert launch.maybe_initialize_distributed()
    nproc, rank = launch.world()
    assert nproc == 2
    bcfg, hcfg = BHFDRConfig(**BCFG), HiccupsConfig(**HCFG)
    out = {'transport': launch.device_transport()[0]}
    out['chrom_dp'] = _payload(api.call_bhfdr(
        uri, bcfg, device='cpu',
        profile_dir=os.path.join(out_dir, 'trace.chrom_dp')))
    out['chrom_dp_mesh'] = _payload(api.call_bhfdr(
        uri, bcfg, mesh=multihost.local_tile_mesh(2, 'cpu'), device='cpu'))

    # a global mesh, two tiles a process; a full-chromosome read raises
    mesh = multihost.global_tile_mesh(['cpu', 'cpu'])
    clr = CoolerLite(uri)
    reads = []
    by_range, whole = CoolerLite.pixels_for_bin1_range, \
        CoolerLite.pixels_for_chrom

    def recording(self, chrom, c0, c1):
        reads.append((chrom, int(c0), int(c1)))
        return by_range(self, chrom, c0, c1)

    CoolerLite.pixels_for_bin1_range = recording
    CoolerLite.pixels_for_chrom = None
    try:
        tables = {}
        for chrom in ('1', '2'):
            bands = multihost.sharded_bands_from_cooler(
                clr, chrom, BCFG['maxapart'], BCFG['maxww'], 3, mesh,
                dtype=np.float64)
            if chrom == '1':
                out['ingest'] = dict(
                    owners=list(mesh.owners),
                    spans={f'{a}:{b}': s.tolist()
                           for (a, b), s in bands.raw_spans.items()},
                    IR=bands.IR.tolist(), gap=bands.gap.astype(int).tolist(),
                    cand_hist=bands.cand_hist.tolist(), nnz=bands.nnz(),
                    L=bands.L, reads=list(reads))
            tables[f'bhfdr.{chrom}'] = engine.bhfdr_chrom(bands, bcfg,
                                                          mesh=mesh)
            tables[f'hiccups.{chrom}'] = engine.hiccups_chrom(bands, hcfg,
                                                              mesh=mesh)
        out['global_engine'] = _payload(tables)
        # one tile a process: chromosome 1's columns straddle the two
        # processes, so its halos carry counts across the boundary
        mesh2 = multihost.global_tile_mesh(['cpu'])
        bands = multihost.sharded_bands_from_cooler(
            clr, '1', BCFG['maxapart'], BCFG['maxww'], 3, mesh2,
            dtype=np.float64)
        out['global_engine_1x2'] = _payload({
            'bhfdr.1': engine.bhfdr_chrom(bands, bcfg, mesh=mesh2),
            'hiccups.1': engine.hiccups_chrom(bands, hcfg, mesh=mesh2)})
        out['global_api'] = _payload(api.call_bhfdr(
            uri, bcfg, mesh=mesh, device='cpu',
            profile_dir=os.path.join(out_dir, 'trace.global_api')))
    finally:
        CoolerLite.pixels_for_bin1_range = by_range
        CoolerLite.pixels_for_chrom = whole
    # the CLI last: it leaves the process group when it is done
    for case, flags in CLI_CASES.items():
        out[f'cli_rc.{case}'] = peakcall.main([
            'pyBHFDR', '-O', os.path.join(out_dir, f'{case}.{rank}.bedpe'),
            '-p', uri, *BHFDR_ARGV, '--device', 'cpu', *flags, '--logFile',
            os.path.join(out_dir, f'{case}.{rank}.log')])
        os.environ['HICPEAKS_COORDINATOR'] = f'localhost:{cli_port}'
    with open(os.path.join(out_dir, f'worker.{rank}.json'), 'w') as f:
        json.dump(out, f)
    print('WORKER-OK', rank, flush=True)


@pytest.fixture(scope='module', autouse=True)
def _root_logger():
    """The JAX CLI reconfigures the root logger; put it back when the
    module is done."""
    import logging
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        root.removeHandler(h)
        if h not in handlers:
            h.close()
    for h in handlers:
        root.addHandler(h)
    root.setLevel(level)


@pytest.fixture(scope='module')
def two_chrom_cooler(tmp_path_factory):
    """tests/test_multihost.py's cooler: two chromosomes (220 and 180
    bins at 25 kb) with ICE-style weights, written by the port's h5lite."""
    from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                                  create_cooler_file)
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    path = tmp_path_factory.mktemp('tmh') / 'two.cool'
    sizes, chunks, weights, offset = {}, [], [], 0
    for chrom, n in (('1', 220), ('2', 180)):
        b1, b2, ct, _, bias = synthesize_chrom(
            n_bins=n, res=RES, seed=7 + n, n_loops=12, depth=60.0)
        sizes[chrom] = n * RES
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        w = np.full(n, np.nan)
        ok = bias > 0
        w[ok] = 1.0 / bias[ok]
        weights.append(w)
        offset += n
    uri = f'{path}::{RES}'
    create_cooler_file(uri, binnify(sizes, RES), chunks,
                       metadata={'onlyIntra': 'True'})
    CoolerLite(uri).write_weights(np.concatenate(weights))
    return uri


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def workers(two_chrom_cooler, tmp_path_factory):
    """Run the two workers once; {rank: payload} and the output dir."""
    out_dir = tmp_path_factory.mktemp('tmh_out')
    port, cli_port = _free_port(), _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, HICPEAKS_COORDINATOR=f'localhost:{port}',
                   HICPEAKS_NUM_PROCESSES='2', HICPEAKS_PROCESS_ID=str(rank),
                   PYTHONPATH=REPO, OMP_NUM_THREADS='2')
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), two_chrom_cooler,
             str(out_dir), str(cli_port)], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (stdout, stderr) in zip(procs, logs):
        assert p.returncode == 0, f'worker failed:\n{stdout}\n{stderr[-4000:]}'
        assert 'WORKER-OK' in stdout
    return {r: json.loads((out_dir / f'worker.{r}.json').read_text())
            for r in range(2)}, out_dir


@pytest.fixture(scope='module')
def jax_bhfdr(two_chrom_cooler):
    """JAX's single-process genome table (tests/test_multihost.py's
    expectation)."""
    from hicpeaks_tpu.api import call_bhfdr
    from hicpeaks_tpu.core.config import BHFDRConfig
    return call_bhfdr(two_chrom_cooler, BHFDRConfig(**BCFG))


def _assert_matches_jax(payload, want, rtol=1e-12):
    """Same chromosomes, pixels and order as JAX's table, geometry equal,
    stats within ``rtol`` (the port's single-process API bar,
    test_torch_api.py)."""
    got = _keyed(payload)
    assert list(got) == list(want)
    assert sum(len(t) for t in want.values()) > 0
    for chrom, table in want.items():
        assert list(got[chrom]) == list(table)
        for k, v in table.items():
            assert tuple(got[chrom][k][:3]) == tuple(v[:3])
            np.testing.assert_allclose(got[chrom][k][3:], v[3:], rtol=rtol,
                                       atol=1e-300)


def _assert_one_trace_a_rank(trace_dir):
    """Two Chrome traces in ``trace_dir``, one for rank 0, one for rank
    1."""
    names = sorted(os.listdir(trace_dir))
    assert len(names) == 2, names
    assert all(n.endswith('.pt.trace.json') for n in names)
    assert [n.split('.')[-5] for n in names] == ['rank0', 'rank1']


def test_worker_imports_no_jax():
    """The worker half of this file imports nothing of JAX at module
    level: its top-level imports are the standard library, numpy and
    pytest."""
    import ast
    with open(__file__) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split('.')[0])
    assert names <= {'json', 'os', 'socket', 'subprocess', 'sys', 'numpy',
                     'pytest'}, names


@pytest.mark.parametrize('case', ['chrom_dp', 'chrom_dp_mesh'])
def test_two_process_distributed_parity(workers, jax_bhfdr, case):
    """Chromosome data-parallelism, with and without a local 2-tile mesh:
    both processes return the whole genome's table, in cooler order, equal
    to JAX's single-process table.  Without the mesh the call was traced
    (``profile_dir``): one trace a process, named by its rank."""
    out, out_dir = workers
    assert out[0][case] == out[1][case]
    _assert_matches_jax(out[0][case], jax_bhfdr)
    if case == 'chrom_dp':
        _assert_one_trace_a_rank(out_dir / 'trace.chrom_dp')


def test_two_process_per_host_ingestion(workers, two_chrom_cooler):
    """Each process reads only the column spans of its two tiles, and the
    spans assemble to the single-process loader's slab; IR is bit-equal to
    JAX's host loader's and to the port's, on both processes."""
    from hicpeaks_tpu.io.coolerlite import CoolerLite as JCoolerLite
    from hicpeaks_tpu.ops.band import bands_from_cooler as jbands
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler

    out, _ = workers
    host = jbands(JCoolerLite(two_chrom_cooler), '1', BCFG['maxapart'],
                  BCFG['maxww'], 3, dtype=np.float64)
    port = bands_from_cooler(CoolerLite(two_chrom_cooler), '1',
                             BCFG['maxapart'], BCFG['maxww'], 3,
                             dtype=np.float64)
    num_p, Lp = host.raw.shape
    assert out[0]['ingest']['owners'] == [0, 0, 1, 1]
    spans = {}
    for r in range(2):
        pl = out[r]['ingest']
        own = sorted(tuple(map(int, k.split(':'))) for k in pl['spans'])
        # the spans of the process's own tiles, and every read inside them
        reads = [(c0, c1) for chrom, c0, c1 in pl['reads']]
        assert {chrom for chrom, _, _ in pl['reads']} == {'1'}
        assert reads and all(any(a <= c0 and c1 <= b for a, b in own)
                             for c0, c1 in reads)
        for k, v in pl['spans'].items():
            spans[tuple(map(int, k.split(':')))] = np.asarray(v)
        np.testing.assert_array_equal(np.asarray(pl['IR']), host.IR)
        np.testing.assert_array_equal(np.asarray(pl['IR']), port.IR)
        np.testing.assert_array_equal(np.asarray(pl['gap'][:Lp], bool),
                                      host.gap)
        assert pl['nnz'] == host.nnz()
    assert out[0]['ingest']['cand_hist'] == out[1]['ingest']['cand_hist']
    cols = sorted(spans)
    assert cols[0][0] == 0 and all(a1 == b0 for (_, b0), (a1, _) in
                                   zip(cols, cols[1:]))
    assembled = np.concatenate([spans[c] for c in cols], axis=1)
    np.testing.assert_array_equal(assembled[:, :Lp], host.raw)
    assert not assembled[:, Lp:].any()


@pytest.mark.parametrize('case,chroms', [
    ('global_engine', ('1', '2')), ('global_engine_1x2', ('1',))])
def test_two_process_global_mesh_engine(workers, two_chrom_cooler, case,
                                        chroms):
    """Both engines on a global mesh, 2 x 2 tiles and 2 x 1 (per-process
    ingestion, halos by send and receive across the process boundary,
    merged compactions): both processes emit the same tables, equal to
    JAX's single-process engines on host bands (tests/test_multihost.py's
    bar, rtol 1e-9)."""
    from hicpeaks_tpu.core import engine
    from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu.io.coolerlite import CoolerLite
    from hicpeaks_tpu.ops.band import bands_from_cooler

    out, _ = workers
    assert out[0]['transport'] == 'gloo'
    t0, t1 = out[0][case], out[1][case]
    assert t0 == t1
    got = _keyed(t0)
    clr = CoolerLite(two_chrom_cooler)
    n = 0
    for chrom in chroms:
        bands = bands_from_cooler(clr, chrom, BCFG['maxapart'],
                                  BCFG['maxww'], 3, dtype=np.float64)
        for kind, want in (
                ('bhfdr', engine.bhfdr_chrom(bands, BHFDRConfig(**BCFG))),
                ('hiccups', engine.hiccups_chrom(bands,
                                                 HiccupsConfig(**HCFG)))):
            table = got[f'{kind}.{chrom}']
            assert set(table) == set(want)
            n += len(want)
            for k in want:
                np.testing.assert_allclose(np.asarray(table[k], float),
                                           np.asarray(want[k], float),
                                           rtol=1e-9)
    assert n > 0


def test_two_process_global_mesh_api(workers, jax_bhfdr):
    """api.call_bhfdr on the global mesh: every process works every
    chromosome and returns the whole table, equal to JAX's
    single-process table and to chromosome data-parallelism's; traced
    (``profile_dir``), each process writes a trace of its own."""
    out, out_dir = workers
    assert out[0]['global_api'] == out[1]['global_api'] == \
        out[0]['chrom_dp']
    _assert_matches_jax(out[0]['global_api'], jax_bhfdr)
    _assert_one_trace_a_rank(out_dir / 'trace.global_api')


@pytest.fixture(scope='module')
def jax_cli_bedpe(two_chrom_cooler, tmp_path_factory):
    """The JAX pyBHFDR CLI's bedpe in one process."""
    from hicpeaks_tpu.cli import peakcall as jcli
    tmp = tmp_path_factory.mktemp('tmh_jax')
    old = os.environ.get('HICPEAKS_NO_COMPILE_CACHE')
    os.environ['HICPEAKS_NO_COMPILE_CACHE'] = '1'
    try:
        want = tmp / 'jax.bedpe'
        assert jcli.bhfdr_main(['-O', str(want), '-p', two_chrom_cooler,
                                *BHFDR_ARGV, '--logFile',
                                str(tmp / 'jax.log')]) == 0
    finally:
        if old is None:
            del os.environ['HICPEAKS_NO_COMPILE_CACHE']
        else:
            os.environ['HICPEAKS_NO_COMPILE_CACHE'] = old
    want = want.read_bytes()
    assert len(want.splitlines()) > 0
    return want


@pytest.mark.parametrize('case', list(CLI_CASES))
def test_two_process_cli_bedpe_byte_identical_to_jax(workers, jax_cli_bedpe,
                                                     case):
    """The pyBHFDR CLI run by both processes of the group, each calling
    its share of the chromosomes or, with ``--mesh-devices 2``, every
    chromosome on its tile of a global mesh: each writes the whole
    genome's bedpe, byte-identical to the JAX CLI's in one process."""
    out, out_dir = workers
    for r in range(2):
        assert out[r][f'cli_rc.{case}'] == 0
        assert (out_dir / f'{case}.{r}.bedpe').read_bytes() == jax_cli_bedpe
    log = (out_dir / f'{case}.0.log').read_text()
    route = 'global 2-tile mesh across 2 processes'
    assert (route in log) == (case == 'global_mesh')


if __name__ == '__main__':
    _worker(*sys.argv[1:4])
