"""Minimal, dependency-light implementation of the Cooler HDF5 schema.

The port's copy of ``hicpeaks_tpu/io/coolerlite.py``, with the reads the
port makes, on ``io/h5lite`` instead of h5py: the same files, with no
dependency beyond numpy and zlib.

The reference package leans on the ``cooler`` library for all matrix storage
(reference: hicpeaks/utilities.py:12-15, 256-265).  That library is not a
dependency here; instead this module reads and writes the same on-disk
HDF5 layout (format ``HDF5::Cooler`` v3, storage-mode ``symmetric-upper``)
so files interoperate with the wider cooler ecosystem:

    /chroms/{name,length}
    /bins/{chrom,start,end[,weight]}
    /pixels/{bin1_id,bin2_id,count}
    /indexes/{chrom_offset,bin1_offset}

URIs follow the ``path::group`` convention used by the reference
(``outfil::res`` at utilities.py:256).
"""
from __future__ import annotations

import json
import os
import datetime

import numpy as np

from . import h5lite

CHUNK = 1 << 20


def parse_cooler_uri(uri: str):
    parts = uri.split('::')
    if len(parts) == 1:
        return parts[0], '/'
    path, group = parts[0], '::'.join(parts[1:])
    if not group.startswith('/'):
        group = '/' + group
    return path, group


def binnify(chromsizes, res: int):
    """Fixed-width bin table: list of (chrom_label, start, end) triples per
    chromosome in ``chromsizes`` order (a dict-like of label -> length)."""
    chroms, starts, ends = [], [], []
    for c, clen in chromsizes.items():
        n = int(np.ceil(clen / res))
        s = np.arange(n, dtype=np.int64) * res
        e = np.minimum(s + res, clen)
        chroms.extend([c] * n)
        starts.append(s)
        ends.append(e)
    return {
        'chrom': np.asarray(chroms, dtype=object),
        'start': np.concatenate(starts) if starts else np.array([], np.int64),
        'end': np.concatenate(ends) if ends else np.array([], np.int64),
    }


def create_cooler_file(uri, bins, pixel_chunks, assembly=None, metadata=None,
                       count_dtype=np.int32, mode='a'):
    """Write a cooler group from a bin table and an iterable of pixel chunks.

    ``pixel_chunks`` yields dicts with ``bin1_id``/``bin2_id``/``count``
    arrays that are globally sorted by (bin1_id, bin2_id), exactly what the
    intra-chromosomal ingestion generator produces (cf. utilities.py:268-325).
    ``mode='a'`` adds the group to an existing file (replacing a group of
    the same name); ``'w'`` starts a new file.  ``indexes/bin1_offset`` is
    counted while the pixels stream (they are sorted by bin1), not read
    back.
    """
    path, group = parse_cooler_uri(uri)
    chrom_labels = list(dict.fromkeys(bins['chrom'].tolist()))
    chrom_id = {c: i for i, c in enumerate(chrom_labels)}
    bins_chrom = np.asarray([chrom_id[c] for c in bins['chrom']], dtype=np.int32)
    nbins = len(bins_chrom)
    lengths = np.asarray(
        [int(bins['end'][bins_chrom == i].max()) for i in range(len(chrom_labels))],
        dtype=np.int32)
    binsize = int(bins['end'][0] - bins['start'][0]) if nbins else 0

    filemode = 'r+' if mode == 'a' and os.path.exists(path) else 'w'
    with h5lite.File(path, filemode) as h5:
        chroms = h5.write_group({
            'name': h5.write_dataset(np.array(chrom_labels, dtype=object)),
            'length': h5.write_dataset(lengths)})
        bins_grp = h5.write_group({
            'chrom': h5.write_dataset(bins_chrom, enum=chrom_id),
            'start': h5.write_dataset(np.asarray(bins['start'], np.int32)),
            'end': h5.write_dataset(np.asarray(bins['end'], np.int32))})

        cols = {'bin1_id': h5.stream(np.int64, CHUNK),
                'bin2_id': h5.stream(np.int64, CHUNK),
                'count': h5.stream(count_dtype, CHUNK)}
        per_bin1 = np.zeros(nbins, np.int64)
        nnz = 0
        total = 0
        for chunk in pixel_chunks:
            b1 = np.asarray(chunk['bin1_id'], np.int64)
            cols['bin1_id'].append(b1)
            cols['bin2_id'].append(np.asarray(chunk['bin2_id'], np.int64))
            ct = np.asarray(chunk['count'])
            cols['count'].append(ct)
            counts = np.bincount(b1, minlength=nbins)
            per_bin1[:nbins] += counts[:nbins]
            nnz += b1.size
            total += float(ct.sum())
        pixels = h5.write_group({k: s.close() for k, s in cols.items()})

        chrom_offset = np.zeros(len(chrom_labels) + 1, dtype=np.int64)
        np.cumsum(np.bincount(bins_chrom, minlength=len(chrom_labels)),
                  out=chrom_offset[1:])
        # searchsorted(bin1, arange(nbins + 1)) of the sorted bin1 column
        bin1_offset = np.zeros(nbins + 1, dtype=np.int64)
        np.cumsum(per_bin1, out=bin1_offset[1:])
        indexes = h5.write_group({
            'chrom_offset': h5.write_dataset(chrom_offset),
            'bin1_offset': h5.write_dataset(bin1_offset)})

        attrs = {
            'format': 'HDF5::Cooler',
            'format-version': 3,
            'format-url': 'https://github.com/open2c/cooler',
            'bin-type': 'fixed',
            'bin-size': binsize,
            'storage-mode': 'symmetric-upper',
            'nchroms': len(chrom_labels),
            'nbins': nbins,
            'nnz': nnz,
            'sum': total,
            'generated-by': 'hicpeaks-tpu',
            'creation-date': datetime.datetime.now().isoformat(),
        }
        if assembly:
            attrs['genome-assembly'] = assembly
        attrs['metadata'] = json.dumps(metadata or {})
        members = {'chroms': chroms, 'bins': bins_grp, 'pixels': pixels,
                   'indexes': indexes}
        _place_group(h5, group, members, attrs)


def _place_group(h5, group, members, attrs):
    """Link a new group of ``members`` and ``attrs`` at ``group``: missing
    parents are created, a group already there is replaced, and at the
    root the members join the file's existing ones (a clash raises, as
    h5py's create_group does)."""
    comps = [c for c in group.split('/') if c]
    if not comps:
        root = h5['/']
        clash = sorted(set(root.keys()) & set(members))
        if clash:
            raise ValueError(f'{h5.path}: root already holds {clash}')
        h5.set_root(h5.write_group({**h5.entries('/'), **members},
                                   {**root.attrs, **attrs}))
        return
    depth = 0
    while depth < len(comps) - 1 and \
            '/' + '/'.join(comps[:depth + 1]) in h5:
        depth += 1
    entry = h5.write_group(members, attrs)
    for name in reversed(comps[depth + 1:]):
        entry = h5.write_group({name: entry})
    h5.link('/' + '/'.join(comps[:depth]), {comps[depth]: entry})


class CoolerLite:
    """Read-side API over a cooler group, shaped after the small subset of
    ``cooler.Cooler`` the reference scripts use (matrix fetch per chromosome,
    bins fetch, binsize/chromnames: scripts/pyHICCUPS:142-163)."""

    def __init__(self, uri: str):
        self.uri = uri
        self.path, self.group = parse_cooler_uri(uri)
        with h5lite.File(self.path) as h5:
            grp = h5[self.group]
            self.info = grp.attrs
            self.binsize = int(self.info['bin-size'])
            self._chromnames = [c if isinstance(c, str) else c.decode()
                                for c in grp['chroms/name'][:]]
            self._chromlengths = grp['chroms/length'][:]
            self._chrom_offset = grp['indexes/chrom_offset'][:]
            self.nbins = int(self.info['nbins'])
            if 'metadata' in self.info:
                try:
                    self.info['metadata'] = json.loads(self.info['metadata'])
                except Exception:
                    pass

    @property
    def chromnames(self):
        return list(self._chromnames)

    @property
    def chromsizes(self):
        return dict(zip(self._chromnames, (int(x) for x in self._chromlengths)))

    def _chrom_index(self, chrom):
        if chrom in self._chromnames:
            return self._chromnames.index(chrom)
        alt = chrom.lstrip('chr') if chrom.startswith('chr') else 'chr' + chrom
        return self._chromnames.index(alt)

    def bin_range(self, chrom):
        ci = self._chrom_index(chrom)
        return int(self._chrom_offset[ci]), int(self._chrom_offset[ci + 1])

    def weights(self, chrom=None, name='weight'):
        with h5lite.File(self.path) as h5:
            grp = h5[self.group]
            if name not in grp['bins']:
                raise KeyError(f'no {name!r} column in bins; balance first')
            w = grp['bins'][name][:]
        if chrom is None:
            return w
        lo, hi = self.bin_range(chrom)
        return w[lo:hi]

    def pixels(self):
        """All stored pixels genome-wide as (bin1_id, bin2_id, count) —
        intra and inter chromosomal, upper-triangle convention.  Feeds the
        trans-inclusive balancing path (utilities.py:398-417)."""
        with h5lite.File(self.path) as h5:
            grp = h5[self.group]
            return (grp['pixels/bin1_id'][:], grp['pixels/bin2_id'][:],
                    grp['pixels/count'][:])

    def pixels_for_chrom(self, chrom):
        """(bin1, bin2, count) local to the chromosome (intra only): the
        rows of its bins, each column inflated on a thread per chunk."""
        lo, hi = self.bin_range(chrom)
        with h5lite.File(self.path) as h5:
            grp = h5[self.group]
            b1o = grp['indexes/bin1_offset']
            plo, phi = int(b1o[lo]), int(b1o[hi])
            b1 = grp['pixels/bin1_id'][plo:phi]
            b2 = grp['pixels/bin2_id'][plo:phi]
            ct = grp['pixels/count'][plo:phi]
        mask = (b2 >= lo) & (b2 < hi)
        return (b1[mask] - lo), (b2[mask] - lo), ct[mask]

    def pixels_for_bin1_range(self, chrom, c0, c1):
        """(bin1, bin2, count) with chromosome-local bin1 in [c0, c1)
        (intra only): the ``indexes/bin1_offset`` table makes the span one
        contiguous row slice, so a process of a tile-sharded run reads
        only its own columns."""
        lo, hi = self.bin_range(chrom)
        r0 = lo + max(0, min(c0, hi - lo))
        r1 = lo + max(0, min(c1, hi - lo))
        with h5lite.File(self.path) as h5:
            grp = h5[self.group]
            b1o = grp['indexes/bin1_offset']
            plo, phi = int(b1o[r0]), int(b1o[r1])
            b1 = grp['pixels/bin1_id'][plo:phi]
            b2 = grp['pixels/bin2_id'][plo:phi]
            ct = grp['pixels/count'][plo:phi]
        mask = (b2 >= lo) & (b2 < hi)
        return (b1[mask] - lo), (b2[mask] - lo), ct[mask]

    def fetch_sparse(self, chrom, balance=False, weight_name='weight'):
        """Symmetric scipy CSR of one chromosome; ``balance`` applies
        ``w[x]*w[y]`` with NaN weights propagating to NaN values, matching
        ``cooler.Cooler.matrix(balance=...)`` semantics."""
        from scipy import sparse
        if isinstance(balance, str):
            weight_name, balance = balance, True
        b1, b2, ct = self.pixels_for_chrom(chrom)
        lo, hi = self.bin_range(chrom)
        n = hi - lo
        data = ct.astype(np.float64)
        if balance:
            w = self.weights(chrom, weight_name)
            data = data * w[b1] * w[b2]
        off = b1 != b2
        rows = np.concatenate([b1, b2[off]])
        cols = np.concatenate([b2, b1[off]])
        vals = np.concatenate([data, data[off]])
        return sparse.csr_matrix((vals, (rows, cols)), shape=(n, n))

    def fetch_dense_region(self, chrom, start, end, balance='weight'):
        """Dense symmetric submatrix of [start, end) in bp (row-aligned to
        bins), used by the plotting CLIs (scripts/peak-plot:99-103)."""
        res = self.binsize
        s0, e0 = start // res, int(np.ceil(end / res))
        M = self.fetch_sparse(chrom, balance=balance)
        sub = M[s0:e0, s0:e0].toarray()
        return sub

    def write_weights(self, weights, stats=None, name='weight'):
        """Persist the balancing vector, mirroring utilities.py:426-431
        (the bins/weight column replaced, stats as attrs)."""
        with h5lite.File(self.path, 'r+') as h5:
            col = h5.write_dataset(np.asarray(weights, np.float64),
                                   attrs=stats)
            h5.link(self.group.rstrip('/') + '/bins', {name: col})
