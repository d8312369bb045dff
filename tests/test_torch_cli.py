"""The port's command-line tools (hicpeaks_tpu_torch/cli/peakcall.py)
against the JAX package's, on one synthetic cooler with weights and the
argv of test_cli_e2e.py: the same flags, byte-identical bedpe files (with
every engine flag value the port serves, ``--mesh-devices`` on CPU tiles
among them), and a non-zero exit where a CUDA card is asked for and
absent."""
import argparse
import logging
import os
import subprocess
import sys

import pytest
import torch

from hicpeaks_tpu.cli import peakcall as jcli
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu_torch.cli import peakcall as tcli

from .torch_threads import one_intra_op_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = {'pyBHFDR': ['--pw', '1', '--ww', '3'],
        'pyHICCUPS': ['--pw', '1', '--ww', '3', '--maxww', '8',
                      '--maxapart', '2000000']}
JAX_MAIN = {'pyBHFDR': jcli.bhfdr_main, 'pyHICCUPS': jcli.hiccups_main}


@pytest.fixture(scope='module', autouse=True)
def _root_logger():
    """The tools reconfigure the root logger (file and console handlers,
    as the reference CLIs do); put it back when the module is done."""
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
def uri(tmp_path_factory):
    path = tmp_path_factory.mktemp('cli') / 'cli.cool'
    u, _ = synthetic_cooler(str(path), n_bins=300, res=25000, seed=5,
                            n_loops=20, depth=80.0)
    return u


def _jax_bedpes(uri, root, *extra):
    """Each JAX tool's bedpe bytes on the cooler with ``extra`` flags
    (compilation cache off, so the run writes nothing outside its
    directory)."""
    old = os.environ.get('HICPEAKS_NO_COMPILE_CACHE')
    os.environ['HICPEAKS_NO_COMPILE_CACHE'] = '1'
    try:
        out = {}
        for tool, main in JAX_MAIN.items():
            bedpe = root / f'{tool}.bedpe'
            assert main(['-O', str(bedpe), '-p', uri, *ARGV[tool],
                         '--logFile', str(root / f'{tool}.log'),
                         *extra]) == 0
            out[tool] = bedpe.read_bytes()
            assert len(out[tool].splitlines()) > 0
    finally:
        if old is None:
            del os.environ['HICPEAKS_NO_COMPILE_CACHE']
        else:
            os.environ['HICPEAKS_NO_COMPILE_CACHE'] = old
    return out


@pytest.fixture(scope='module')
def jax_bedpe(uri, tmp_path_factory):
    """Each JAX tool's bedpe bytes at its default flags."""
    return _jax_bedpes(uri, tmp_path_factory.mktemp('jax_cli'))


@pytest.fixture(scope='module')
def jax_bedpe_host_bh(uri, tmp_path_factory):
    """Each JAX tool's bedpe bytes with ``--bh-backend host``: the dense
    scorer's table, which is not the default one."""
    return _jax_bedpes(uri, tmp_path_factory.mktemp('jax_cli_host'),
                       '--bh-backend', 'host')


def _port(tool, uri, tmp_path, *extra):
    bedpe = tmp_path / 'port.bedpe'
    rc = tcli.main([tool, '-O', str(bedpe), '-p', uri, *ARGV[tool],
                    '--device', 'cpu', '--logFile', str(tmp_path / 'p.log'),
                    *extra])
    return rc, bedpe


@pytest.mark.parametrize('tool', list(ARGV))
def test_bedpe_byte_identical_to_jax(uri, jax_bedpe, tool, tmp_path):
    rc, bedpe = _port(tool, uri, tmp_path)
    assert rc == 0
    assert bedpe.read_bytes() == jax_bedpe[tool]


@pytest.mark.parametrize('tool', list(ARGV))
def test_flags_without_effect(uri, jax_bedpe, tool, tmp_path):
    """--shape-bucket and --nproc are accepted and logged as without
    effect; the served engine flags leave the output unchanged."""
    rc, bedpe = _port(tool, uri, tmp_path, '--shape-bucket', '512',
                      '--nproc', '3', '--scan-backend', 'pallas',
                      '--bh-backend', 'device')
    assert rc == 0
    assert bedpe.read_bytes() == jax_bedpe[tool]
    text = (tmp_path / 'p.log').read_text()
    assert '--shape-bucket 512 has no effect' in text
    assert '--nproc 3 has no effect' in text


def _options(main, monkeypatch):
    """{option string: (default, type, nargs, choices)} of a tool's parser,
    captured as it parses."""
    seen = {}

    def capture(self, *a, **k):
        seen['parser'] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, 'parse_args', capture)
    with pytest.raises(SystemExit):
        main([])
    monkeypatch.undo()
    return {s: (a.default, a.type, a.nargs, a.choices)
            for a in seen['parser']._actions for s in a.option_strings}


@pytest.mark.parametrize('tool', list(ARGV))
def test_flag_surface_is_the_jax_clis(tool, monkeypatch):
    want = _options(JAX_MAIN[tool], monkeypatch)
    got = _options(tcli.TOOLS[tool], monkeypatch)
    assert got.pop('--device') == ('cuda', None, None, None)
    assert got == want


@pytest.mark.parametrize('tool', list(ARGV))
@pytest.mark.parametrize('flags', [
    ['--scan-backend', 'jnp'], ['--scan-backend', 'pallas-interpret'],
    ['--scan-backend', 'validate'], ['--bh-backend', 'host'],
    ['--checkify']])
def test_served_flags_match_jax_bedpe(uri, jax_bedpe, jax_bedpe_host_bh,
                                      tool, flags, tmp_path):
    """The flags of the fallback ladder and checkify write the JAX CLI's
    bedpe with the same flags: its default bedpe where the flag leaves the
    JAX table as it is, its own run for ``--bh-backend host``."""
    rc, bedpe = _port(tool, uri, tmp_path, *flags)
    assert rc == 0
    want = jax_bedpe_host_bh if '--bh-backend' in flags else jax_bedpe
    assert bedpe.read_bytes() == want[tool]


@pytest.mark.parametrize('tool', list(ARGV))
@pytest.mark.parametrize('flags', [['--mesh-devices', '2'],
                                   ['--mesh-devices', '7']])
def test_mesh_devices_cli_matches_jax(uri, jax_bedpe, tool, flags,
                                      tmp_path):
    """``--mesh-devices N`` with ``--device cpu`` runs each chromosome on
    N CPU tiles (7 does not divide the band's width) and the bedpe is the
    JAX CLI's, as JAX's own mesh writes its single-device table
    (test_sharded.py)."""
    rc, bedpe = _port(tool, uri, tmp_path, *flags)
    assert rc == 0
    assert bedpe.read_bytes() == jax_bedpe[tool]
    assert f'TileMesh([{", ".join(["cpu"] * int(flags[1]))}])' in \
        (tmp_path / 'p.log').read_text()


def _run_module(args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, '-m', 'hicpeaks_tpu_torch.cli.peakcall', *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


def test_module_mesh_devices_runs_and_cards_without_cuda_fail(uri, jax_bedpe, tmp_path):
    """The module with ``--mesh-devices 2 --device cpu`` exits 0 and
    writes the JAX CLI's bedpe; a mesh of cards on a machine without CUDA
    is refused with a non-zero exit, never run on the CPU."""
    out = tmp_path / 'x.bedpe'
    proc = _run_module(['pyBHFDR', '-O', str(out), '-p', uri, *ARGV[
        'pyBHFDR'], '--device', 'cpu', '--mesh-devices', '2', '--logFile',
        str(tmp_path / 'x.log')])
    assert proc.returncode == 0, proc.stderr
    assert out.read_bytes() == jax_bedpe['pyBHFDR']
    if torch.cuda.is_available():
        return
    out.unlink()
    proc = _run_module(['pyBHFDR', '-O', str(out), '-p', uri,
                        '--mesh-devices', '2', '--logFile',
                        str(tmp_path / 'y.log')])
    assert proc.returncode != 0
    assert 'RuntimeError' in proc.stderr and 'CUDA' in proc.stderr
    assert not out.exists()


def test_cuda_device_without_cuda_exits_nonzero(uri, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the refusal path needs none')
    proc = _run_module(['pyBHFDR', '-O', str(tmp_path / 'x.bedpe'), '-p',
                        uri, '--logFile', str(tmp_path / 'x.log')])
    assert proc.returncode != 0
    assert 'RuntimeError' in proc.stderr and 'CUDA' in proc.stderr
    assert not (tmp_path / 'x.bedpe').exists()
