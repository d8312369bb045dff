"""The port's combine-resolutions (hicpeaks_tpu_torch/core/combine.py,
cli/combine.py) and multi-resolution synthesis against the JAX package's:
``combine_annotations`` equal on tests/test_combine.py's cases and on
seeded multi-resolution peak sets drawn from ``synthesize_chrom_multires``,
the synthesis equal, and the CLI's file byte-identical to
``hicpeaks_tpu.cli.combine``'s."""
import numpy as np
import pytest

from hicpeaks_tpu.cli import combine as jcli
from hicpeaks_tpu.core.combine import combine_annotations as jcombine
from hicpeaks_tpu.io.synth import synthesize_chrom_multires as jmultires
from hicpeaks_tpu_torch.cli import combine as tcli
from hicpeaks_tpu_torch.core.combine import combine_annotations as tcombine
from hicpeaks_tpu_torch.io.synth import synthesize_chrom_multires as tmultires

from .torch_threads import one_intra_op_thread  # noqa: F401

RESOLUTIONS = (5000, 10000, 25000)


def _peak(s1, s2, res):
    return (s1, s1 + res, s2, s2 + res)


# tests/test_combine.py's three cases: (byres, keyword arguments)
JAX_CASES = {
    'single_resolution_passthrough': (
        {10000: {'1': [_peak(100000, 500000, 10000)]}}, {}),
    'fine_confirmed_by_coarse': (
        {10000: {'1': [_peak(100000, 500000, 10000)]},
         20000: {'1': [_peak(100000, 500000, 20000)]}},
        dict(good_res=20000, mindis=100000, max_res=20000)),
    'unconfirmed_fine_dropped_unless_close': (
        {5000: {'1': [_peak(100000, 900000, 5000),
                      _peak(100000, 140000, 5000)]},
         20000: {'1': [_peak(3_000_000, 4_000_000, 20000)]}},
        dict(good_res=10000, mindis=100000, max_res=20000)),
}


def multires_peaks(seed, n_fine=1200, chroms=('21', '22')):
    """Seeded peak sets at 5, 10 and 25 kb over the planted loops of one
    ``synthesize_chrom_multires`` draw per chromosome: each loop is called
    at a resolution with probability 0.7, one bin off in x or y one time
    in four, plus a few calls at random places."""
    rng = np.random.default_rng(seed)
    byres = {r: {} for r in RESOLUTIONS}
    for i, c in enumerate(chroms):
        _, loops, _ = tmultires(n_fine, fine_res=5000, resolutions=(5000,),
                                seed=seed * 10 + i, n_loops=40,
                                max_loop_span_bins=300)
        for r in RESOLUTIONS:
            f, n = r // 5000, -(-n_fine * 5000 // r)
            got = set()
            for x, y in loops:
                if rng.random() < 0.7:
                    jx, jy = rng.integers(-1, 2, 2) * (rng.random() < 0.25)
                    got.add((min(max(x // f + jx, 0), n - 1),
                             min(max(y // f + jy, 0), n - 1)))
            for x in rng.integers(0, n - 20, 5):
                got.add((int(x), int(x + rng.integers(2, 20))))
            byres[r][c] = [_peak(int(x) * r, int(y) * r, r)
                           for x, y in sorted(got, key=lambda p: rng.random())]
    return byres


SEEDED = {f'multires_seed{s}_{"_".join(map(str, kw.values())) or "defaults"}':
          (s, kw) for s, kw in ((1, {}), (2, {}),
                                (3, dict(good_res=10000, mindis=100000,
                                         max_res=10000)),
                                (4, dict(good_res=20000, mindis=200000,
                                         max_res=25000)))}


@pytest.mark.parametrize('case', list(JAX_CASES) + list(SEEDED))
def test_combine_annotations_equal_jax(case):
    if case in JAX_CASES:
        byres, kw = JAX_CASES[case]
    else:
        seed, kw = SEEDED[case]
        byres = multires_peaks(seed)
    got = tcombine(byres, **kw)
    assert got == jcombine(byres, **kw)
    assert got
    if case in SEEDED:
        # a real multi-resolution set: a 5 kb peak (finer than good_res)
        # farther apart than mindis is kept only when a coarser peak
        # confirms it
        mindis = kw.get('mindis', 100000)
        assert any(t[2] - t[1] == 5000 and t[4] - t[1] > mindis
                   for t in got)


@pytest.mark.parametrize('seed', [3, 7])
def test_synthesize_chrom_multires_equals_jax(seed):
    kw = dict(seed=seed, depth=8.0, n_loops=20)
    got, loops, bias = tmultires(400, fine_res=5000,
                                 resolutions=RESOLUTIONS, **kw)
    want, jloops, jbias = jmultires(400, fine_res=5000,
                                    resolutions=RESOLUTIONS, **kw)
    assert loops == jloops and np.array_equal(bias, jbias)
    assert set(got) == set(want)
    for r in RESOLUTIONS:
        for a, b in zip(got[r], want[r]):
            assert np.array_equal(a, b) and np.asarray(a).dtype == \
                np.asarray(b).dtype


def _write_peakfiles(root, byres, header):
    paths = []
    for r, peaks in byres.items():
        path = root / f'peaks{r}.bedpe'
        with open(path, 'w') as f:
            if header:
                f.write('chrom1\tstart1\tend1\tchrom2\tstart2\tend2\n')
            for c, lst in peaks.items():
                for p in lst:
                    f.write(f'chr{c}\t{p[0]}\t{p[1]}\tchr{c}\t{p[2]}\t{p[3]}'
                            '\t.\t12\t.\t.\t2.5\t1e-06\t0.001\n')
        paths.append(str(path))
    return paths


@pytest.mark.parametrize('flags', [
    [], ['-G', '10000', '-M', '100000'], ['--max-res', '25000'],
    ['-S', '1']], ids=['defaults', 'good_res_min_dis', 'max_res', 'skip'])
def test_combine_cli_byte_identical(tmp_path, flags):
    byres = multires_peaks(5)
    paths = _write_peakfiles(tmp_path, byres, header='-S' in flags)
    argv = ['-p', *paths, '-R', *map(str, byres), *flags]
    assert jcli.main(['-O', str(tmp_path / 'jax.bedpe'), *argv]) == 0
    assert tcli.main(['-O', str(tmp_path / 'port.bedpe'), *argv]) == 0
    got = (tmp_path / 'port.bedpe').read_bytes()
    assert got == (tmp_path / 'jax.bedpe').read_bytes()
    assert len(got.splitlines()) > 10
