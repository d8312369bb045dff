"""The port's toCooler (hicpeaks_tpu_torch/cli/tocooler.py, --device cpu)
against the JAX toCooler on the same TXT folder and NPZ archive, intra-only
and with --includeTrans, for both pixel types: chroms, bins and pixels
equal, weights at the ICE bar of test_torch_ice.py.  Then both packages'
peak-calling CLIs on their own toCooler outputs (byte-identical bedpe), and
the copies toCooler rests on: the native TXT parser and the chromosome
sizes."""
import io
import logging
import os

import h5py
import numpy as np
import pytest

from hicpeaks_tpu.cli import peakcall as jpeak
from hicpeaks_tpu.cli import tocooler as jtoc
from hicpeaks_tpu.io import chromsizes as jsizes
from hicpeaks_tpu.io.synth import synthesize_chrom
from hicpeaks_tpu_torch.cli import peakcall as tpeak
from hicpeaks_tpu_torch.cli import tocooler as ttoc
from hicpeaks_tpu_torch.io import chromsizes as tsizes
from hicpeaks_tpu_torch.io import fastload
from hicpeaks_tpu_torch.io.synth import write_txt

from .torch_threads import one_intra_op_thread  # noqa: F401

RES = 25000
NBINS = {'21': 150, '22': 110}


@pytest.fixture(scope='module', autouse=True)
def _root_logger():
    """Both CLIs reconfigure the root logger, as the reference's do; put it
    back when the module is done."""
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
def data(tmp_path_factory):
    """Two chromosomes and one trans pair as a TXT folder and as an NPZ
    archive (the same pixels; 2 % of the intra lines mirrored below the
    diagonal, and some duplicated), with sizes and metadata files."""
    root = tmp_path_factory.mktemp('tocooler')
    rng = np.random.default_rng(11)
    pairs = {}
    for i, (c, n) in enumerate(NBINS.items()):
        b1, b2, ct, _, _ = synthesize_chrom(n_bins=n, res=RES, seed=20 + i,
                                            n_loops=12, depth=70.0)
        flip = rng.random(b1.size) < 0.02
        b1, b2 = np.where(flip, b2, b1), np.where(flip, b1, b2)
        dup = rng.random(b1.size) < 0.01
        pairs[f'{c}_{c}'] = (np.r_[b1, b1[dup]], np.r_[b2, b2[dup]],
                             np.r_[ct, ct[dup]])
    tx = rng.integers(0, NBINS['21'], 1500)
    ty = rng.integers(0, NBINS['22'], 1500)
    pairs['21_22'] = (tx, ty, rng.integers(1, 6, tx.size))
    folder = root / '25K'
    folder.mkdir()
    rec = np.dtype({'names': ['bin1', 'bin2', 'IF'],
                    'formats': [np.int32, np.int32, np.float64]})
    arrays = {}
    for key, (x, y, v) in pairs.items():
        write_txt(str(folder / f'{key}.txt'), x, y, v)
        a = np.zeros(x.size, rec)
        a['bin1'], a['bin2'], a['IF'] = x, y, v
        arrays[key] = a
    np.savez(root / 'data.npz', **arrays)
    (root / 'sizes').write_text(''.join(f'chr{c}\t{n * RES}\n'
                                        for c, n in NBINS.items()))
    (root / 'meta_txt').write_text(f'res:{RES}\n{folder}\n')
    (root / 'meta_npz').write_text(f'res:{RES}\n{root / "data.npz"}\n')
    return root


def _tocooler(main, data, out, source, trans, ptype, *extra):
    argv = ['-O', str(out), '-d', str(data / f'meta_{source}'),
            '--chromsizes-file', str(data / 'sizes'), '--pixel-type', ptype,
            '--logFile', f'{out}.log', *extra]
    return main(argv + (['--includeTrans'] if trans else []))


def _read(path):
    """h5py's view of the cooler group: {dataset path: values}, weights
    apart."""
    out = {}
    with h5py.File(path, 'r') as h:
        g = h[str(RES)]
        g.visititems(lambda n, o: out.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize('ptype', ['int', 'float'])
@pytest.mark.parametrize('trans', [False, True])
@pytest.mark.parametrize('source', ['txt', 'npz'])
def test_tocooler_matches_jax(data, tmp_path, source, trans, ptype):
    j, t = tmp_path / 'j.cool', tmp_path / 't.cool'
    assert _tocooler(jtoc.main, data, j, source, trans, ptype) == 0
    assert _tocooler(ttoc.main, data, t, source, trans, ptype,
                     '--device', 'cpu') == 0
    want, got = _read(j), _read(t)
    assert want.keys() == got.keys()
    for name in want:
        if name == 'bins/weight':
            continue
        assert got[name].dtype == want[name].dtype, name
        assert np.array_equal(got[name], want[name]), name
    assert got['pixels/bin1_id'].size > 0
    if trans:
        assert (np.searchsorted(got['indexes/chrom_offset'],
                                got['pixels/bin2_id'], 'right')
                != np.searchsorted(got['indexes/chrom_offset'],
                                   got['pixels/bin1_id'], 'right')).any()
    w, v = got['bins/weight'], want['bins/weight']
    assert np.array_equal(np.isnan(w), np.isnan(v))
    np.testing.assert_allclose(w, v, rtol=1e-9)
    with h5py.File(j, 'r') as hj, h5py.File(t, 'r') as ht:
        assert dict(ht[f'{RES}/bins/weight'].attrs) == \
            dict(hj[f'{RES}/bins/weight'].attrs)


def test_existing_output_is_refused(data, tmp_path):
    out = tmp_path / 'x.cool'
    out.write_bytes(b'')
    assert _tocooler(ttoc.main, data, out, 'txt', False, 'int',
                     '--device', 'cpu') == 1
    assert 'FileExistsError' in open(f'{out}.log').read()


@pytest.mark.parametrize('tool,argv', [
    ('pyBHFDR', ['--pw', '1', '--ww', '3']),
    ('pyHICCUPS', ['--pw', '1', '--ww', '3', '--maxww', '8',
                   '--maxapart', '2000000'])])
def test_peak_clis_on_tocooler_outputs(data, tmp_path, monkeypatch, tool,
                                       argv):
    """Each package's toCooler output through its own peak caller: the
    same bedpe bytes."""
    monkeypatch.setenv('HICPEAKS_NO_COMPILE_CACHE', '1')
    j, t = tmp_path / 'j.cool', tmp_path / 't.cool'
    assert _tocooler(jtoc.main, data, j, 'txt', False, 'int') == 0
    assert _tocooler(ttoc.main, data, t, 'txt', False, 'int',
                     '--device', 'cpu') == 0
    jmain = {'pyBHFDR': jpeak.bhfdr_main, 'pyHICCUPS': jpeak.hiccups_main}
    assert jmain[tool](['-O', str(tmp_path / 'j.bedpe'), '-p',
                        f'{j}::{RES}', *argv,
                        '--logFile', str(tmp_path / 'j.log')]) == 0
    assert tpeak.main([tool, '-O', str(tmp_path / 't.bedpe'), '-p',
                       f'{t}::{RES}', *argv, '--device', 'cpu',
                       '--logFile', str(tmp_path / 't.log')]) == 0
    want = (tmp_path / 'j.bedpe').read_bytes()
    assert want.count(b'\n') > 0
    assert (tmp_path / 't.bedpe').read_bytes() == want


def test_fastload_matches_loadtxt(data, tmp_path):
    for key in ('21_21', '21_22'):
        path = str(data / '25K' / f'{key}.txt')
        b1, b2, ct = fastload.load_txt(path)
        ref = np.loadtxt(path)
        np.testing.assert_array_equal(b1, ref[:, 0].astype(np.int64))
        np.testing.assert_array_equal(b2, ref[:, 1].astype(np.int64))
        np.testing.assert_array_equal(ct, ref[:, 2])
    empty = tmp_path / 'empty.txt'
    empty.write_text('')
    assert all(a.size == 0 for a in fastload.load_txt(str(empty)))


class _FakeResponse(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.mark.parametrize('chroms', [('#', 'X'), (), ('X', '2')])
def test_chromsizes_copy_matches_jax(tmp_path, chroms):
    """The cases of test_chromsizes.py: the UCSC body through an injected
    opener, the offline error, and a sizes file."""
    body = (b'chr1\t248956422\nchr2\t242193529\nchrX\t156040895\n'
            b'chrY\t57227415\nchrM\t16569\nchr1_KI270706v1_random\t175055\n')
    urls = []

    def fake(url, timeout=None):
        urls.append(url)
        return _FakeResponse(body)

    assert tsizes.fetch_chromsizes('hg38', chroms, _urlopen=fake) == \
        jsizes.fetch_chromsizes('hg38', chroms, _urlopen=fake)
    assert urls[0] == urls[1] == jsizes.UCSC_CHROMSIZES_URL.format(
        assembly='hg38')

    def dead(url, timeout=None):
        raise OSError('Name or service not known')

    with pytest.raises(ConnectionError, match='--chromsizes-file'):
        tsizes.fetch_chromsizes('hg38', chroms, _urlopen=dead)
    f = tmp_path / 'sizes'
    f.write_text('chr21\t46709983\nchrX 156040895\nchr2\t242193529\n')
    assert tsizes.read_chromsizes(str(f), chroms) == \
        jsizes.read_chromsizes(str(f), chroms)
    labels = ['X', '10', '2', 'M', 'Y', 'Un', '1']
    assert tsizes.sort_chromlabels(labels) == jsizes.sort_chromlabels(labels)


def test_ingest_assembly_only(data, tmp_path, monkeypatch):
    """Without --chromsizes-file the sizes come from fetch_chromsizes, as
    in test_chromsizes.py; here an injected one."""
    from hicpeaks_tpu_torch.io import ingest
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    monkeypatch.setattr(ingest, 'fetch_chromsizes',
                        lambda assembly, chroms: {'21': NBINS['21'] * RES})
    out = ingest.ingest({RES: str(data / '25K')}, str(tmp_path / 'a.cool'),
                        chromsizes_file=None, assembly='hg38')
    clr = CoolerLite(f'{out}::{RES}')
    assert clr.chromnames == ['21']
    assert clr.chromsizes == {'21': NBINS['21'] * RES}
    assert clr.info['genome-assembly'] == 'hg38'
    assert clr.pixels_for_chrom('21')[2].sum() > 0
