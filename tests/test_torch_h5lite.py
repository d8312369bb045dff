"""The port's HDF5 subset (hicpeaks_tpu_torch/io/h5lite.py) with h5py as
the oracle: the reader against h5py on files h5py writes (coolers of the
JAX writer, several resolutions, deep chunk B-trees, big groups, many
attributes, fixed-length strings), any 1-D slice, the unsupported layouts
raising by name; and the writer: h5py and the JAX CoolerLite read the port's
coolers equal to the JAX writer's, after ``mode='a'`` and ``write_weights``
on files of either writer, at a file size close to h5py's."""
import os
import shutil

import h5py
import numpy as np
import pytest

from hicpeaks_tpu.io import coolerlite as jcl
from hicpeaks_tpu_torch.io import coolerlite as tcl
from hicpeaks_tpu_torch.io import h5lite

RES = 10000
SIZES = {'1': 2_000_000, '2': 1_200_000, 'X': 700_000}
STATS = {'tol': 1e-5, 'min_nnz': 10, 'min_count': 0, 'mad_max': 5,
         'cis_only': True, 'ignore_diags': 1, 'converged': False}


def _pixels(seed=0, n=40000, chunk=15000):
    """Sorted unique upper-triangle pixels over SIZES' bins, in chunks."""
    rng = np.random.default_rng(seed)
    nb = sum(-(-s // RES) for s in SIZES.values())
    b1 = rng.integers(0, nb, n)
    b2 = np.minimum(b1 + rng.integers(0, 60, n), nb - 1)
    key = np.unique(b1 * nb + b2)
    b1, b2 = key // nb, key % nb
    ct = rng.integers(1, 90, b1.size)
    return [{'bin1_id': b1[i:i + chunk], 'bin2_id': b2[i:i + chunk],
             'count': ct[i:i + chunk]} for i in range(0, b1.size, chunk)]


def _write(module, path, resolutions=(RES,), seed=0, **kw):
    for i, res in enumerate(resolutions):
        module.create_cooler_file(f'{path}::{res}',
                                  jcl.binnify(SIZES, RES), _pixels(seed + i),
                                  assembly='hg38',
                                  metadata={'onlyIntra': 'True'}, **kw)
    return path


def assert_reads_equal(path):
    """Every group, dataset and attribute of ``path`` reads the same
    through h5lite as through h5py: names in order, values, dtypes, chunk
    shapes, and slices of every 1-D dataset."""
    with h5py.File(path, 'r') as h, h5lite.File(path) as lite:
        def walk(name):
            ho, lo = h[name], lite[name]
            want, got = dict(ho.attrs), lo.attrs
            assert list(got) == list(want), name
            for k, v in want.items():
                assert type(got[k]) is type(v), (name, k)
                assert np.array_equal(got[k], v), (name, k)
                assert getattr(got[k], 'dtype', None) == \
                    getattr(v, 'dtype', None), (name, k)
            if isinstance(ho, h5py.Group):
                assert lo.keys() == list(ho), name
                for k in ho:
                    walk(name.rstrip('/') + '/' + k)
                return
            a, b = ho[()], lo[()]
            assert (a.dtype, a.shape, lo.chunks) == (b.dtype, b.shape,
                                                     ho.chunks), name
            assert np.array_equal(a, b), name
            n = len(a)
            for s in (slice(0, n), slice(1, max(n - 1, 1)),
                      slice(n // 3, n // 2), slice(n, n)):
                assert np.array_equal(ho[s], lo[s]), (name, s)
        walk('/')


def _dump(path):
    """h5py's view of a file: {name: attrs} for groups, {name: (values,
    dtype, attrs)} for datasets, creation-date left out."""
    out = {}

    def visit(name, obj):
        attrs = {k: v for k, v in obj.attrs.items() if k != 'creation-date'}
        if isinstance(obj, h5py.Dataset):
            out[name] = (obj[()].tolist(), obj.dtype, obj.chunks, attrs)
        else:
            out[name] = attrs
    with h5py.File(path, 'r') as h:
        h.visititems(visit)
    return out


@pytest.fixture(scope='module')
def jax_cooler(tmp_path_factory):
    root = tmp_path_factory.mktemp('h5lite')
    before = _write(jcl, str(root / 'j.cool'))
    after = str(root / 'jw.cool')
    shutil.copy(before, after)
    jcl.CoolerLite(f'{after}::{RES}').write_weights(
        np.linspace(0.5, 1.5, 390), STATS)
    multi = _write(jcl, str(root / 'multi.cool'), (RES, 20000, 50000))
    return dict(before=before, after=after, multi=multi, root=root)


@pytest.mark.parametrize('which', ['before', 'after', 'multi'])
def test_reader_equals_h5py_on_jax_coolers(jax_cooler, which):
    assert_reads_equal(jax_cooler[which])
    for res in ((RES, 20000, 50000) if which == 'multi' else (RES,)):
        uri = f'{jax_cooler[which]}::{res}'
        t, j = tcl.CoolerLite(uri), jcl.CoolerLite(uri)
        assert t.info == j.info
        assert t.info['metadata'] == {'onlyIntra': 'True'}
        assert (t.chromnames, t.chromsizes, t.nbins, t.binsize) == \
            (j.chromnames, j.chromsizes, j.nbins, j.binsize)
        for c in SIZES:
            for x, y in zip(t.pixels_for_chrom(c), j.pixels_for_chrom(c)):
                assert np.array_equal(x, y)
            assert (t.fetch_sparse(c) != j.fetch_sparse(c)).nnz == 0
        for x, y in zip(t.pixels(), j.pixels()):
            assert np.array_equal(x, y)
        if which == 'after':
            assert np.array_equal(t.weights('2'), j.weights('2'))
            assert (t.fetch_sparse('1', balance=True) !=
                    j.fetch_sparse('1', balance=True)).nnz == 0


@pytest.fixture(scope='module')
def odd_file(tmp_path_factory):
    """An h5py file with the layouts a cooler may not have: a deep chunk
    B-tree (unfiltered and filtered), 25 members in one group, 35
    attributes, fixed-length strings, array attributes."""
    path = str(tmp_path_factory.mktemp('odd') / 'odd.h5')
    x = np.arange(100_000, dtype=np.int64) * 3 - 7
    with h5py.File(path, 'w') as h:
        h.create_dataset('deep', data=x, chunks=(1024,))
        h.create_dataset('deep_gz', data=x, chunks=(1000,),
                         compression='gzip', shuffle=True)
        g = h.create_group('many')
        for i in range(25):
            g.create_dataset(f'd{i:02d}', data=np.arange(i + 1, dtype='<f4'))
        for i in range(35):
            g.attrs[f'a{i:02d}'] = i if i % 3 else f'v{i}'
        g.attrs['flag'] = np.True_
        h.create_dataset('names', data=np.array([b'chr1', b'chr22', b'X'],
                                                'S5'))
        h.attrs['fixed'] = np.bytes_(b'abc')
        h.attrs['floats'] = np.arange(3.0)
        h.attrs['strs'] = ['x', 'yy']
    return path


def test_reader_equals_h5py_on_odd_layouts(odd_file):
    with h5lite.File(odd_file) as f:
        assert len(f['many'].keys()) == 25 and len(f['many'].attrs) == 36
    assert_reads_equal(odd_file)


@pytest.mark.parametrize('lo,hi', [(0, 1), (1023, 1025), (5000, 70001),
                                   (99_000, 100_000), (64 * 1024, 65 * 1024),
                                   (-5, None), (7, 7)])
def test_slices_equal_h5py(odd_file, lo, hi):
    with h5py.File(odd_file, 'r') as h, h5lite.File(odd_file) as f:
        for name in ('deep', 'deep_gz'):
            assert np.array_equal(f[name][lo:hi], h[name][lo:hi])
        assert f['deep'][lo] == h['deep'][lo]


def test_unsupported_layouts_raise_by_name(tmp_path):
    latest = str(tmp_path / 'latest.h5')
    with h5py.File(latest, 'w', libver='latest') as h:
        h['x'] = np.arange(3)
    with pytest.raises(h5lite.UnsupportedFeature, match='superblock version'):
        h5lite.File(latest)
    other = str(tmp_path / 'other.h5')
    with h5py.File(other, 'w') as h:
        h.create_dataset('f32', data=np.arange(100), chunks=(10,),
                         fletcher32=True)
        h.create_group('ordered', track_order=True)
    with h5lite.File(other) as f:
        with pytest.raises(h5lite.UnsupportedFeature, match='fletcher32'):
            f['f32'][:]
        with pytest.raises(h5lite.UnsupportedFeature,
                           match='version-2 object header'):
            f['ordered']


def test_writer_cooler_reads_equal_to_jax_writer(tmp_path):
    j = _write(jcl, str(tmp_path / 'j.cool'), (RES, 20000))
    t = _write(tcl, str(tmp_path / 't.cool'), (RES, 20000))
    assert _dump(t) == _dump(j)
    assert_reads_equal(t)
    for res in (RES, 20000):
        a, b = jcl.CoolerLite(f'{t}::{res}'), jcl.CoolerLite(f'{j}::{res}')
        info_a, info_b = dict(a.info), dict(b.info)
        assert info_a.pop('creation-date') != ''
        info_b.pop('creation-date')
        assert info_a == info_b
        for c in SIZES:
            for x, y in zip(a.pixels_for_chrom(c), b.pixels_for_chrom(c)):
                assert np.array_equal(x, y)


@pytest.mark.parametrize('first,second', [('jax', 'port'), ('port', 'jax'),
                                          ('port', 'port')])
def test_mode_a_and_write_weights_across_writers(tmp_path, first, second):
    """A second resolution and a weight column added by either package to
    a file of either: h5py and both readers see what an all-JAX file
    holds."""
    mods = {'jax': jcl, 'port': tcl}
    ref = _write(jcl, str(tmp_path / 'ref.cool'), (RES, 20000))
    path = _write(mods[first], str(tmp_path / 'x.cool'), (RES,))
    mods[second].create_cooler_file(f'{path}::20000', jcl.binnify(SIZES, RES),
                                    _pixels(1), assembly='hg38',
                                    metadata={'onlyIntra': 'True'})
    for res, who in ((RES, second), (20000, first)):
        for k in range(2):     # write, then replace the column
            w = np.linspace(0.1, 1 + k, 390)
            mods[who].CoolerLite(f'{path}::{res}').write_weights(w, STATS)
            mods['jax'].CoolerLite(f'{ref}::{res}').write_weights(w, STATS)
    assert _dump(path) == _dump(ref)
    assert_reads_equal(path)
    for res in (RES, 20000):
        t = tcl.CoolerLite(f'{path}::{res}')
        assert np.array_equal(t.weights(), jcl.CoolerLite(
            f'{ref}::{res}').weights())


def test_replacing_a_group_and_a_root_cooler(tmp_path):
    """mode='a' on an existing resolution replaces it (the JAX writer
    deletes it first); a cooler at the root of a new file."""
    path = _write(tcl, str(tmp_path / 'x.cool'), (RES,))
    tcl.create_cooler_file(f'{path}::{RES}', jcl.binnify(SIZES, RES),
                           _pixels(5), metadata={'onlyIntra': 'True'})
    ref = _write(jcl, str(tmp_path / 'ref.cool'), (RES,), seed=5)
    ref_d, got_d = _dump(ref), _dump(path)
    for name in ref_d:
        if isinstance(ref_d[name], dict):
            ref_d[name].pop('genome-assembly', None)
    assert got_d == ref_d
    root = str(tmp_path / 'root.cool')
    tcl.create_cooler_file(root, jcl.binnify(SIZES, RES), _pixels(2))
    jroot = str(tmp_path / 'jroot.cool')
    jcl.create_cooler_file(jroot, jcl.binnify(SIZES, RES), _pixels(2))
    assert _dump(root) == _dump(jroot)


def test_writer_deep_trees_big_groups_many_attrs(tmp_path):
    """Layouts the cooler writer reaches only at scale: a chunk B-tree of
    two levels (150k elements in 1024-element chunks), a group of 25
    members (four SNOD nodes), 35 attributes of every kind."""
    x = np.arange(150_000, dtype=np.int64) * 7
    path = str(tmp_path / 'w.h5')
    attrs = {f'a{i:02d}': (i if i % 3 else f's{i}') for i in range(35)}
    attrs.update(flag=np.False_, f=2.5, arr=np.arange(4, dtype=np.int32))
    with h5lite.File(path, 'w') as f:
        s = f.stream(np.int64, 1024)
        s.append(x[:70_001])
        s.append(x[70_001:])
        members = {'big': s.close({'n': 1})}
        members.update({f'm{i:02d}': f.write_dataset(
            np.arange(i + 1, dtype=np.float32)) for i in range(25)})
        members['s'] = f.write_dataset(np.array(['ab', 'c' * 30], object))
        f.set_root(f.write_group({'g': f.write_group(members, attrs)}))
    with h5py.File(path, 'r') as h:
        assert np.array_equal(h['g/big'][:], x)
        assert h['g/big'].chunks == (1024,)
        assert list(h['g']) == sorted(members)
        got = dict(h['g'].attrs)
        assert got.keys() == attrs.keys()
        for k, v in attrs.items():
            assert np.array_equal(got[k], v), k
        assert list(h['g/s'][:]) == [b'ab', b'c' * 30]
    assert_reads_equal(path)


def test_pixel_heavy_file_size(tmp_path):
    """At depth the pixel columns are the file: the port's is at most
    1.1x h5py's plus 64 KB."""
    rng = np.random.default_rng(3)
    nb = 390
    b1 = np.sort(rng.integers(0, nb, 1_500_000))
    b2 = np.minimum(b1 + rng.integers(0, 80, b1.size), nb - 1)
    chunks = [{'bin1_id': b1, 'bin2_id': b2,
               'count': rng.integers(1, 300, b1.size)}]
    sizes = {}
    for tag, mod in (('j', jcl), ('t', tcl)):
        p = str(tmp_path / f'{tag}.cool')
        mod.create_cooler_file(f'{p}::{RES}', jcl.binnify(SIZES, RES),
                               chunks)
        sizes[tag] = os.path.getsize(p)
    assert sizes['t'] <= 1.1 * sizes['j'] + 65536, sizes
