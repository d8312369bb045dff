"""TXT/NPZ ingestion into cooler files.

The port's copy of ``hicpeaks_tpu/io/ingest.py``; it writes through the
port's ``io/coolerlite`` (no h5py) and parses TXT with the port's native
parser (``io/fastload``).

Host-side equivalent of the reference's ``Genome`` class
(utilities.py:130-364): scans per-resolution TXT folders
(``{c1}_{c2}.txt``) or NPZ archives, enforces upper-triangle storage with
the reference's exact symmetrization (mirror lower triangle, keep upper),
offsets bins to genome-wide ids via cumulative bin counts, and writes one
cooler group per resolution (``outfil::res``).  TXT parsing uses the
native mmap parser (io/fastload) instead of np.loadtxt — the reference's
dominant toCooler cost (README.rst:287-291).

Bounded-memory ingestion: like the reference's temp-cooler external merge
(``create_from_unordered``, utilities.py:51-127), each normalized chunk is
spilled to disk as a sorted run and the runs are k-way merged in fixed-size
blocks into the output cooler, so peak RSS is one chunk plus the merge
buffers regardless of total contact count (the reference stays <3GB at
140M contacts; so does this).
"""
from __future__ import annotations

import glob
import logging
import os
import tempfile

import numpy as np
from scipy import sparse

from .chromsizes import (read_chromsizes, fetch_chromsizes, sort_chromlabels,
                         _label_selected)
from .coolerlite import binnify, create_cooler_file
from .fastload import load_txt

log = logging.getLogger(__name__)


def scan_txt_folder(folder, chroms):
    """{(c1, c2): path} for ``*_*.txt`` files with selected labels
    (utilities.py:327-351)."""
    mapping = {}
    for path in glob.glob(os.path.join(folder, '*_*.txt')):
        name = os.path.split(path)[1]
        parts = name.rstrip('.txt').split('_')
        if len(parts) != 2:
            continue
        c1, c2 = parts
        if _label_selected(c1, chroms) and _label_selected(c2, chroms):
            mapping[(c1, c2)] = path
    return mapping


def scan_npz(path, chroms):
    """{(c1, c2): key} plus the archive handle (utilities.py:209-226)."""
    lib = np.load(path)
    mapping = {}
    for key in lib.files:
        if '_' not in key:
            if _label_selected(key, chroms):
                mapping[(key, key)] = key
            continue
        parts = key.split('_')
        if len(parts) != 2:
            continue
        c1, c2 = parts
        if _label_selected(c1, chroms) and _label_selected(c2, chroms):
            mapping[(c1, c2)] = key
    return lib, mapping


def _symmetrize_upper(x, y, vals, n):
    """The reference's intra-pair normalization (utilities.py:306-312):
    sum duplicates, mirror each stored (x, y) onto (y, x), keep the upper
    triangle.

    Implemented with sorts instead of the reference's
    ``lil[y, x] = lil[x, y]`` (a scipy fancy-assignment that costs
    seconds per million pixels — over half of ingestion wall time at the
    reference's benchmark scales).  Semantics preserved exactly,
    including the quirk that when BOTH (a, b) and (b, a) appear in the
    input, the mirror assignment overwrites the original upper value with
    the lower one (the RHS is gathered before assignment, so the final
    (a, b) carries the deduplicated (b, a) sum); proven equal to a
    literal transcription in test_ingest_symmetrize."""
    key = x.astype(np.int64) * n + y.astype(np.int64)
    uk, inv = np.unique(key, return_inverse=True)
    sums = np.bincount(inv, weights=np.asarray(vals, np.float64))
    ux = uk // n
    uy = uk % n
    # upper-triangle position of each deduplicated entry; entries coming
    # from the lower triangle are mirror-assignment targets and overwrite
    # originals at the same upper position
    fx = np.where(ux <= uy, ux, uy)
    fy = np.where(ux <= uy, uy, ux)
    is_mirror = ux > uy
    k2 = fx * n + fy
    order = np.lexsort((is_mirror, k2))     # mirror sorts after original
    k2s = k2[order]
    vs = sums[order]
    last = np.r_[np.diff(k2s) != 0, True]   # keep the last per key
    keys = k2s[last]
    return keys // n, keys % n, vs[last]


class _SortedRun:
    """One spilled chunk: (bin1, bin2, count) strictly increasing in the
    packed key ``bin1 * nbins + bin2``, memory-mapped from disk."""

    def __init__(self, prefix, nbins):
        self.b1 = np.load(prefix + '.b1.npy', mmap_mode='r')
        self.b2 = np.load(prefix + '.b2.npy', mmap_mode='r')
        self.ct = np.load(prefix + '.ct.npy', mmap_mode='r')
        self.n = self.b1.shape[0]
        self.pos = 0
        self.nbins = nbins

    @staticmethod
    def spill(tmpdir, tag, b1, b2, ct):
        prefix = os.path.join(tmpdir, tag)
        np.save(prefix + '.b1.npy', np.asarray(b1, np.int64))
        np.save(prefix + '.b2.npy', np.asarray(b2, np.int64))
        np.save(prefix + '.ct.npy', np.asarray(ct))
        return prefix

    def exhausted(self):
        return self.pos >= self.n

    def key_at(self, i):
        return int(self.b1[i]) * self.nbins + int(self.b2[i])


def _merge_runs(runs, nbins, block_rows=1 << 19):
    """Stream the union of sorted runs in global (bin1, bin2) order using
    O(len(runs) * block_rows) memory — the external k-way merge phase of
    the reference's ``create_from_unordered`` (utilities.py:100-127),
    vectorized: every round loads one block per live run, emits all rows
    below the smallest not-yet-loaded key, and refills."""
    live = [r for r in runs if not r.exhausted()]
    while live:
        bound = None                      # smallest key beyond a loaded block
        for r in live:
            end = min(r.pos + block_rows, r.n)
            if end < r.n:
                k = r.key_at(end)
                bound = k if bound is None else min(bound, k)
        b1s, b2s, cts, keys = [], [], [], []
        for r in live:
            end = min(r.pos + block_rows, r.n)
            b1 = np.asarray(r.b1[r.pos:end], np.int64)
            b2 = np.asarray(r.b2[r.pos:end], np.int64)
            key = b1 * nbins + b2
            take = key.size if bound is None else \
                int(np.searchsorted(key, bound, side='left'))
            if take:
                b1s.append(b1[:take])
                b2s.append(b2[:take])
                cts.append(np.asarray(r.ct[r.pos:r.pos + take]))
                keys.append(key[:take])
                r.pos += take
        key = np.concatenate(keys)
        order = np.argsort(key, kind='stable')
        yield {'bin1_id': np.concatenate(b1s)[order],
               'bin2_id': np.concatenate(b2s)[order],
               'count': np.concatenate(cts)[order]}
        live = [r for r in live if not r.exhausted()]


def ingest(datasets, outfil, chromsizes_file, chroms=('#', 'X'),
           only_intra=True, assembly='hg38', dtype='int'):
    """Build ``outfil`` with one cooler group per resolution.

    ``datasets``: {resolution: folder-or-npz-path}, the toCooler metadata
    format (scripts/toCooler:12-25).
    """
    chroms = set(chroms) if chroms else set()
    outfil = os.path.abspath(os.path.expanduser(outfil))
    if os.path.exists(outfil):
        raise FileExistsError(f'Cooler file {outfil} already exists')

    # --chromsizes-file wins when given; otherwise fetch from UCSC by
    # assembly name, matching the reference's precedence
    # (utilities.py:186-193).
    if chromsizes_file:
        log.info('Read chromosome sizes from %s', chromsizes_file)
        sizes = read_chromsizes(chromsizes_file, chroms)
    else:
        log.info('Fetch chromosome sizes from UCSC ...')
        sizes = fetch_chromsizes(assembly, chroms)
    order = sort_chromlabels(sizes.keys())
    count_dtype = np.int32 if dtype == 'int' else np.float64

    for res, source in datasets.items():
        if str(source).endswith('.npz'):
            lib, mapping = scan_npz(source, chroms)
            reader = lambda key: (lib[key]['bin1'], lib[key]['bin2'],
                                  lib[key]['IF'])
        else:
            mapping = scan_txt_folder(source, chroms)
            reader = load_txt

        present = {c for pair in mapping for c in pair}
        chromlist = [c for c in order if c in present]
        chromsizes = {c: sizes[c] for c in chromlist}
        n_bins = {c: int(np.ceil(sizes[c] / res)) for c in chromlist}
        offsets = {}
        acc = 0
        for c in chromlist:
            offsets[c] = acc
            acc += n_bins[c]

        nbins_total = acc
        with tempfile.TemporaryDirectory(prefix='hicpeaks_ingest_') as tmpdir:
            # spill phase: one chunk resident at a time, each written out as
            # a sorted run (csr round-trips emit row-major order, so runs
            # are already strictly increasing in (bin1, bin2))
            runs_by_c1 = {c: [] for c in chromlist}
            n_pixels = 0
            for i, c1 in enumerate(chromlist):
                for c2 in chromlist[i:]:
                    if only_intra and c1 != c2:
                        continue
                    if (c1, c2) in mapping:
                        key, swap = (c1, c2), False
                    elif (c2, c1) in mapping:
                        key, swap = (c2, c1), True
                    else:
                        continue
                    x, y, vals = reader(mapping[key])
                    x = np.asarray(x, np.int64)
                    y = np.asarray(y, np.int64)
                    vals = np.asarray(vals, np.float64)
                    if swap:
                        x, y = y, x
                    if c1 == c2:
                        n = int(max(x.max(), y.max())) + 1 if x.size else 0
                        x, y, vals = _symmetrize_upper(x, y, vals, n)
                    elif x.size:
                        # trans pairs go through the same sparse round-trip
                        # the reference applies (utilities.py:313-321):
                        # duplicates summed, stored zeros dropped, rows sorted
                        T = sparse.coo_matrix(
                            (vals, (x, y)),
                            shape=(n_bins[c1], n_bins[c2])).tocsr()
                        T.eliminate_zeros()
                        T = T.tocoo()
                        x, y, vals = T.row, T.col, T.data
                    if not len(x):
                        continue
                    runs_by_c1[c1].append(_SortedRun.spill(
                        tmpdir, f'{c1}_{c2}', x + offsets[c1],
                        y + offsets[c2], vals.astype(count_dtype)))
                    n_pixels += len(x)

            # merge phase: row-chromosome groups are disjoint and ordered in
            # (bin1, bin2), so stream each group's k-way merge in turn
            def merged_blocks():
                for c1 in chromlist:
                    runs = [_SortedRun(p, nbins_total)
                            for p in runs_by_c1[c1]]
                    yield from _merge_runs(runs, nbins_total)

            bins = binnify(chromsizes, res)
            uri = f'{outfil}::{res}'
            log.info('Writing %s (%d pixels)', uri, n_pixels)
            create_cooler_file(uri, bins, merged_blocks(),
                               assembly=assembly,
                               metadata={'onlyIntra': str(bool(only_intra))},
                               count_dtype=count_dtype)
    return outfil


def parse_datasets_metadata(metadata_path):
    """The toCooler ``-d`` metadata format: ``res:<int>`` lines followed by
    data paths (scripts/toCooler:12-25)."""
    datasets = {}
    res = None
    with open(metadata_path) as source:
        for line in source:
            if line.startswith('res'):
                res = int(line.rstrip().split(':')[1])
            elif not line.isspace() and line.strip():
                datasets[res] = os.path.abspath(os.path.expanduser(line.strip()))
    return datasets
