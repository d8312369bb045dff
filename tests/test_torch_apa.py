"""The port's APA (hicpeaks_tpu_torch/ops/apa_ops.py, cli/apa.py) against
the JAX package's on the inputs of tests/test_apa.py: the window stage
bit-equal to the JAX CLI's float64 host path (its own source lines, re-run
on the same band) for w = 3, 5 and 7 (w = 7 reaches numpy's pairwise
recursion above 128 cells), within 1e-12 of JAX's ``apa_windows`` under
x64, ``locate_peak_bins`` and ``apa_analysis`` equal, and the CLI's count
and stack equal to the JAX CLI's on a synthetic cooler, also where the
cooler stores every distance and the port builds fewer diagonals."""
import inspect
import textwrap
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hicpeaks_tpu.cli import apa as japa_cli
from hicpeaks_tpu.io.synth import synthetic_cooler
from hicpeaks_tpu.ops import apa_ops as japa
from hicpeaks_tpu_torch.cli import apa as tapa_cli
from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                              create_cooler_file)
from hicpeaks_tpu_torch.ops import apa_ops as tapa

from .test_apa import _StubClr
from .torch_threads import one_intra_op_thread  # noqa: F401

WINDOWS = (3, 5, 7)
POS = [(20, 60), (3, 50), (10, 40), (30, 36), (114, 118), (50, 90),
       (12, 13), (40, 100), (8, 8)]


def _jax_host_stage():
    """The float64 window stage of the JAX CLI's main, from its own source
    (``ww = args.window`` through ``norm = ...``), as a function of
    (band, nanband, pos, w, L) that returns the kept windows."""
    lines = inspect.getsource(japa_cli.main).splitlines()
    i0 = next(i for i, s in enumerate(lines) if 'ww = args.window' in s)
    i1 = next(i for i, s in enumerate(lines) if s.strip().startswith('norm ='))
    body = textwrap.dedent('\n'.join(lines[i0:i1 + 1]))

    def run(band, nanband, pos, w, L):
        scope = dict(np=np, band=band, nanband=nanband, pos=pos, L=L,
                     num=band.shape[0], args=types.SimpleNamespace(window=w))
        exec(body, scope)
        return scope['norm']
    return run


def _test_apa_band(balanced=True):
    """tests/test_apa.py's matrix (seed 2, n = 120, a NaN at (10, 40)) as
    the upper band and NaN band of every diagonal; ``balanced`` scales it
    by w[i] * w[j] (w from the same generator), so that window sums are
    not integers and their order shows in the last bits."""
    rng = np.random.default_rng(2)
    n = 120
    A = rng.poisson(2.0, (n, n)).astype(float)
    M = np.triu(A) + np.triu(A, 1).T
    M[10, 40] = M[40, 10] = np.nan
    if balanced:
        wv = rng.uniform(0.5, 2.0, n)
        M = M * wv[:, None] * wv[None, :]
    band = np.zeros((n, n))
    nanband = np.zeros((n, n))
    for d in range(n):
        idx = np.arange(n - d)
        vals = M[idx, idx + d]
        nanband[d, idx] = np.isnan(vals)
        band[d, idx] = np.where(np.isnan(vals), 0.0, vals)
    return band, nanband, n


def _port_windows(band, nanband, pos, w, L):
    xs = torch.tensor([p[0] for p in pos])
    ys = torch.tensor([p[1] for p in pos])
    return tapa.apa_windows(torch.from_numpy(band), torch.from_numpy(nanband),
                            xs, ys, w, L)


@pytest.mark.parametrize('balanced', [False, True])
@pytest.mark.parametrize('w', WINDOWS)
def test_apa_windows_bit_equal_to_jax_host_stage(w, balanced):
    band, nanband, n = _test_apa_band(balanced)
    norm, ok, _ = _port_windows(band, nanband, POS, w, n)
    got = norm[ok].numpy()
    want = _jax_host_stage()(band, nanband, POS, w, n)
    assert len(want) > 0
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    plain = tapa.apa_windows_host(band, nanband, [p[0] for p in POS],
                                  [p[1] for p in POS], w, n)
    assert np.array_equal(plain.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize('n', [1, 7, 8, 9, 49, 120, 121, 128, 129, 169, 225,
                               1000])
def test_pairwise_sum_is_numpys(n):
    x = np.random.default_rng(n).random((40, n)) * 1e3
    got = tapa.pairwise_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.add.reduce(x, axis=1))


@pytest.mark.parametrize('w', WINDOWS)
def test_apa_windows_within_1e12_of_jax(w):
    band, nanband, n = _test_apa_band()
    norm, ok, means = _port_windows(band, nanband, POS, w, n)
    jn, jok, jmeans = japa.apa_windows(
        jnp.asarray(band), jnp.asarray(nanband),
        jnp.asarray([p[0] for p in POS]), jnp.asarray([p[1] for p in POS]),
        w, n)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(means.numpy(), np.asarray(jmeans), rtol=1e-12)
    np.testing.assert_allclose(norm.numpy()[ok.numpy()],
                               np.asarray(jn)[np.asarray(jok)], rtol=1e-12)


def _stub_cases():
    n = 40
    raw = np.zeros((n, n))
    bal = np.zeros((n, n))
    raw[11, 31] = 100.0
    raw[12, 30] = 10.0
    bal[11, 31] = 1.0
    bal[12, 30] = 5.0
    bal[10, 32] = np.nan
    return {'balanced': _StubClr(raw, bal),
            'all_nan': _StubClr(np.zeros((n, n)), np.full((n, n), np.nan))}


@pytest.mark.parametrize('case', ['balanced', 'all_nan'])
@pytest.mark.parametrize('balance', [False, 'weight'])
def test_locate_peak_bins_equals_jax(case, balance):
    clr = _stub_cases()[case]
    peaks = [(100, 130, 300, 330), (50, 60, 50, 60), (0, 25, 380, 405)]
    for min_dis in (0, 3, 30):
        got = tapa_cli.locate_peak_bins(clr, 'x', peaks, 10, min_dis,
                                        balance=balance)
        assert got == japa_cli.locate_peak_bins(clr, 'x', peaks, 10, min_dis,
                                                balance=balance)


def test_apa_analysis_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w, cw = 5, 3
    stack = rng.random((50, 2 * w + 1, 2 * w + 1)) + 0.5
    stack[:, w, w] += 3.0
    got = tapa.apa_analysis(stack, w=w, cw=cw)
    want = japa.apa_analysis(stack, w=w, cw=cw)
    assert np.array_equal(got[0], want[0])
    assert [float(v) for v in got[1:]] == [float(v) for v in want[1:]]


def _capture(module, monkeypatch):
    """Record the stack each call of ``module.apa_analysis`` receives."""
    seen = []
    real = module.apa_analysis

    def spy(apa_stack, *a, **k):
        seen.append(np.array(apa_stack))
        return real(apa_stack, *a, **k)
    monkeypatch.setattr(module, 'apa_analysis', spy)
    return seen


def _bedpe(path, loops, res, chrom='21'):
    with open(path, 'w') as f:
        for x, y in loops:
            f.write(f'{chrom}\t{x * res}\t{(x + 1) * res}\t'
                    f'{chrom}\t{y * res}\t{(y + 1) * res}\n')
    return str(path)


def _both_clis(uri, bedpe, tmp_path, capsys, monkeypatch, *flags):
    """(printed count, stack) of the JAX CLI's default host path and of the
    port's CLI on the CPU, on the same argv."""
    argv = ['-p', uri, '-I', bedpe, '-S', '0', *flags]
    jseen = _capture(japa, monkeypatch)
    assert japa_cli.main(['-O', str(tmp_path / 'jax.png'), *argv]) == 0
    j_out = capsys.readouterr().out.split()
    tseen = _capture(tapa, monkeypatch)
    assert tapa_cli.main(['-O', str(tmp_path / 'port.png'), *argv,
                          '--device', 'cpu']) == 0
    t_out = capsys.readouterr().out.split()
    return (j_out[-1], jseen[-1]), (t_out[-1], tseen[-1])


@pytest.mark.parametrize('w', WINDOWS)
def test_cli_count_and_stack_equal_jax(tmp_path, capsys, monkeypatch, w):
    uri, loops = synthetic_cooler(str(tmp_path / 'apa.cool'), n_bins=400,
                                  res=25000, seed=5, n_loops=25, depth=60.0)
    bedpe = _bedpe(tmp_path / 'loops.bedpe', loops, 25000)
    (jn, jstack), (tn, tstack) = _both_clis(
        uri, bedpe, tmp_path, capsys, monkeypatch, '-M', '5', '-W', str(w))
    assert tn == jn and int(tn) == len(tstack) > 0
    assert tstack.shape == jstack.shape
    assert np.array_equal(tstack.view(np.int64), jstack.view(np.int64))


def test_band_cut_changes_no_window(tmp_path, capsys, monkeypatch):
    """A cooler that stores every distance: JAX's band holds all of them,
    the port's only those the windows reach; the stacks are bit-equal."""
    L, res, w = 160, 10000, 5
    rng = np.random.default_rng(11)
    b1, b2 = np.triu_indices(L)
    ct = rng.poisson(30.0 / (1.0 + b2 - b1) ** 0.5) + 1
    uri = f'{tmp_path / "dense.cool"}::{res}'
    create_cooler_file(uri, binnify({'1': L * res}, res),
                       [{'bin1_id': b1, 'bin2_id': b2, 'count': ct}])
    weights = rng.uniform(0.5, 2.0, L)
    weights[[7, 70, 71]] = np.nan
    CoolerLite(uri).write_weights(weights)
    loops = [(x, x + d) for x, d in zip(rng.integers(0, L - 40, 30),
                                        rng.integers(12, 40, 30))]
    bedpe = _bedpe(tmp_path / 'loops.bedpe', loops, res, chrom='1')
    rows = []
    real = tapa.apa_band

    def spy(*a):
        rows.append(a[5])
        return real(*a)
    monkeypatch.setattr(tapa, 'apa_band', spy)
    (jn, jstack), (tn, tstack) = _both_clis(uri, bedpe, tmp_path, capsys,
                                            monkeypatch, '-M', '5')
    assert rows == [max(y - x for x, y in loops) + 2 * w + 2]
    assert rows[0] < L + w + 1      # JAX's band: every diagonal + w + 2
    assert tn == jn and int(tn) == len(tstack) > 0
    assert np.array_equal(tstack.view(np.int64), jstack.view(np.int64))


def test_cuda_device_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the refusal path needs none')
    uri, loops = synthetic_cooler(str(tmp_path / 'c.cool'), n_bins=100,
                                  res=25000, seed=1, n_loops=5)
    peaks = {'21': [(x * 25000, (x + 1) * 25000, y * 25000, (y + 1) * 25000)
                    for x, y in loops]}
    with pytest.raises(RuntimeError, match='CUDA'):
        tapa_cli.apa_stats(CoolerLite(uri), peaks, device='cuda')
