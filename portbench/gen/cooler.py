"""The benchmark's frozen cooler writer.

A copy of the writing half of ``hicpeaks_tpu_torch/io/h5lite.py`` (the
HDF5 subset coolers use: superblock 0, old-style groups, version-1 object
headers, chunked 1-D datasets with shuffle and deflate 6) and of
``io/coolerlite.create_cooler_file``, kept here so that a change to the
program's I/O cannot change the benchmark's input files.  It writes a new
file only, with the weight column in the bins group from the start and a
fixed creation date, so that one seed gives the same bytes.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEF = 0xFFFFFFFFFFFFFFFF
_FREE_NULL = 1                  # end of a local heap's free list
_LEAF_K, _GROUP_K, _CHUNK_K = 4, 16, 32     # HDF5's defaults
_GCOL_MIN = 4096
DEFLATE_LEVEL = 6

_DATASPACE, _DATATYPE, _FILL = 1, 3, 5
_LAYOUT, _FILTERS, _ATTR, _STAB = 8, 11, 12, 17

Entry = namedtuple('Entry', 'addr btree heap')
"""A written object: its header address and, for a group, its B-tree and
local heap (the addresses a parent's entry caches)."""


def guess_chunk(shape, typesize):
    """h5py's chunk shape for a dataset created with data and no chunks
    (``h5py/_hl/filters.py`` ``guess_chunk``)."""
    chunks = np.array([x if x else 1024 for x in shape], dtype='=f8')
    dset_size = np.prod(chunks) * typesize
    target = 16 * 1024 * (2 ** np.log10(dset_size / (1024. * 1024)))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    idx = 0
    while True:
        nbytes = np.prod(chunks) * typesize
        if (nbytes < target or abs(nbytes - target) / target < 0.5) and \
                nbytes < 1024 * 1024:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _pad8(b):
    return b + b'\0' * (-len(b) % 8)


def shuffle(raw, esize):
    """HDF5's shuffle filter: byte j of element i moves to j * n + i; a
    tail shorter than one element stays in place."""
    n = len(raw) // esize
    if esize <= 1 or n <= 1:
        return raw
    body = np.frombuffer(raw, np.uint8, n * esize).reshape(n, esize)
    out = np.empty((esize, n), np.uint8)
    # one byte lane at a time: numpy's copy of the whole transposed view
    # is several times slower, and it is most of a chunk's read
    for j in range(esize):
        out[j] = body[:, j]
    return out.tobytes() + raw[n * esize:]


def _int_type(dtype):
    dtype = np.dtype(dtype)
    bits = 0x08 if dtype.kind == 'i' else 0
    return struct.pack('<BBBBIHH', 0x10, bits, 0, 0, dtype.itemsize, 0,
                       dtype.itemsize * 8)


def _encode_type(dtype, enum=None):
    """Datatype message bytes for a numpy dtype ('O' = variable-length
    UTF-8 string, bool = h5py's int8 enum, ``enum`` = {name: value} over
    an integer dtype)."""
    dtype = np.dtype(dtype)
    if dtype.kind == 'b':
        enum, dtype = {'FALSE': 0, 'TRUE': 1}, np.dtype(np.int8)
    if enum is not None:
        base = _int_type(dtype)
        names = b''.join(_pad8(str(k).encode() + b'\0') for k in enum)
        values = np.asarray(list(enum.values()), dtype.newbyteorder('<'))
        return struct.pack('<BHBI', 0x18, len(enum), 0, dtype.itemsize) + \
            base + names + values.tobytes()
    if dtype.kind in 'iu':
        return _int_type(dtype)
    if dtype.kind == 'f':
        if dtype.itemsize == 8:
            props = struct.pack('<HHBBBBI', 0, 64, 52, 11, 0, 52, 1023)
        elif dtype.itemsize == 4:
            props = struct.pack('<HHBBBBI', 0, 32, 23, 8, 0, 23, 127)
        else:
            raise ValueError(f'writing {dtype}')
        return struct.pack('<BBBBI', 0x11, 0x20, dtype.itemsize * 8 - 1, 0,
                           dtype.itemsize) + props
    if dtype.kind in 'OU':
        return struct.pack('<BBBBI', 0x19, 0x01, 0x01, 0, 16) + \
            struct.pack('<BBBBIHH', 0x10, 0, 0, 0, 1, 0, 8)
    if dtype.kind == 'S':
        return struct.pack('<BBBBI', 0x13, 0, 0, 0, dtype.itemsize)
    raise ValueError(f'writing numpy dtype {dtype}')


def _encode_space(shape, maxshape=None):
    if maxshape is None:
        return struct.pack('<BBBBI', 1, len(shape), 0, 0, 0) + \
            struct.pack(f'<{len(shape)}Q', *shape)
    return struct.pack('<BBBBI', 1, len(shape), 1, 0, 0) + \
        struct.pack(f'<{2 * len(shape)}Q', *shape,
                    *(UNDEF if m is None else m for m in maxshape))


def _encode_filters(esize):
    """Shuffle (over ``esize``-byte elements; none for 0) then deflate 6,
    both optional, as h5py's ``compression='gzip', shuffle=True``."""
    shuf = struct.pack('<HHHH', 2, 8, 1, 1 if esize else 0) + b'shuffle\0'
    if esize:
        shuf += struct.pack('<II', esize, 0)
    defl = struct.pack('<HHHH', 1, 8, 1, 1) + b'deflate\0' + \
        struct.pack('<II', DEFLATE_LEVEL, 0)
    return struct.pack('<BB6x', 1, 2) + shuf + defl


class File:
    """A new HDF5 file, written by appends."""

    def __init__(self, path):
        self.path = path
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        self._gcol = None           # the writer's collection: [addr, size, used, idx]
        self._pool = None
        try:
            self._create()
        except BaseException:
            os.close(self._fd)
            raise

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._fd is None:
            return
        try:
            if self._pool is not None:
                self._pool.shutdown()
            self._pwrite(self._eof_off, struct.pack('<Q', self._eof))
        finally:
            os.close(self._fd)
            self._fd = None

    def _pwrite(self, addr, data):
        os.pwrite(self._fd, data, addr)

    def _append(self, data):
        addr = self._eof
        self._pwrite(addr, data)
        self._eof += len(data)
        return addr

    def _create(self):
        self._leaf_k, self._group_k, self._chunk_k = \
            _LEAF_K, _GROUP_K, _CHUNK_K
        self._eof_off, self._root_off, self._eof = 40, 56, 96
        self._pwrite(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) +
                     struct.pack('<HHI4Q', _LEAF_K, _GROUP_K, 0, 0, UNDEF, 96,
                                 UNDEF) + b'\0' * 40)
        self.set_root(self.write_group({}))

    def _header(self, msgs):
        """Append a v1 object header of [(type, flags, data)]."""
        body = b''.join(struct.pack('<HHB3x', t, len(_pad8(d)), fl) + _pad8(d)
                        for t, fl, d in msgs)
        return self._append(struct.pack('<BBHII4x', 1, 0, len(msgs), 1,
                                        len(body)) + body)

    def _vlen_ref(self, b):
        """Store ``b`` in the writer's global heap collection; -> the
        16-byte (length, collection, index) record."""
        need = 16 + len(_pad8(b))
        col = self._gcol
        if col is None or col[2] + need > col[1] or \
                0 < col[1] - col[2] - need < 16:
            size = max(_GCOL_MIN, 16 + need + 16)
            addr = self._append(b'GCOL' + bytes([1, 0, 0, 0]) +
                                struct.pack('<Q', size) + b'\0' * (size - 16))
            col = self._gcol = [addr, size, 16, 1]
        addr, size, used, idx = col
        obj = struct.pack('<HH4xQ', idx, 0, len(b)) + _pad8(b)
        free = size - used - need
        tail = struct.pack('<HH4xQ', 0, 0, free) if free else b''
        self._pwrite(addr + used, obj + tail)
        col[2], col[3] = used + need, idx + 1
        return struct.pack('<IQI', len(b), addr, idx)

    def _encode_values(self, arr):
        """Stored bytes of a numpy array (strings through the global
        heap)."""
        if arr.dtype.kind in 'OU':
            return b''.join(self._vlen_ref(
                v if isinstance(v, bytes) else str(v).encode())
                for v in arr.reshape(-1))
        if arr.dtype.kind == 'b':
            arr = arr.astype(np.int8)
        return np.ascontiguousarray(arr).tobytes()

    def _attr_message(self, name, value):
        if isinstance(value, (str, bytes)) and not isinstance(value, np.bytes_):
            arr = np.array([value], object).reshape(())
        elif isinstance(value, bool):
            arr = np.array(value)
        elif isinstance(value, int):
            arr = np.array(value, np.int64)
        elif isinstance(value, float):
            arr = np.array(value, np.float64)
        else:
            arr = np.asarray(value)
        dt = _encode_type(arr.dtype)
        sp = _encode_space(arr.shape)
        nm = name.encode() + b'\0'
        return struct.pack('<BBHHH', 1, 0, len(nm), len(dt), len(sp)) + \
            _pad8(nm) + _pad8(dt) + _pad8(sp) + self._encode_values(arr)

    def write_group(self, members, attrs=None):
        """Append a new group holding ``members`` ({name: Entry}) with
        ``attrs``; -> its Entry (not yet linked anywhere)."""
        btree, heap = self._write_table(members)
        msgs = [(_STAB, 0, struct.pack('<QQ', btree, heap))]
        msgs += [(_ATTR, 0, self._attr_message(k, v))
                 for k, v in (attrs or {}).items()]
        return Entry(self._header(msgs), btree, heap)

    def _write_table(self, members):
        """Local heap, SNOD nodes and B-tree for {name: Entry} ->
        (btree, heap); a group's entry caches its B-tree and heap."""
        members = sorted((n.encode(), e) for n, e in members.items())
        names = [n for n, _ in members]
        if any(b'/' in n or not n for n in names):
            raise ValueError(f'bad member names {names}')
        data, offs = bytearray(8), []
        for n in names:
            offs.append(len(data))
            data += _pad8(n + b'\0')
        heap = self._append(b'HEAP' + bytes(4) + struct.pack(
            '<QQQ', len(data), _FREE_NULL, self._eof + 32) + bytes(data))
        per = 2 * self._leaf_k
        leaves = []
        for s in range(0, len(members), per):
            part = members[s:s + per]
            body = b''
            for (_, e), off in zip(part, offs[s:s + per]):
                cached = e.btree is not None
                body += struct.pack('<QQI4x', off, e.addr, int(cached)) + (
                    struct.pack('<QQ', e.btree, e.heap) if cached
                    else bytes(16))
            node = b'SNOD' + bytes([1, 0]) + struct.pack('<H', len(part)) + \
                body + bytes(40 * (per - len(part)))
            leaves.append((struct.pack('<Q', 0 if not s else offs[s - 1]),
                           self._append(node),
                           struct.pack('<Q', offs[s + len(part) - 1])))
        if not leaves:
            leaves = None
        btree = self._write_btree(0, leaves, self._group_k, 8,
                                  struct.pack('<Q', 0))
        return btree, heap

    def _write_btree(self, typ, children, k, key_size, empty_key):
        """A v1 B-tree over [(left key, child addr, right key)] in key
        order (None: an empty root); -> root address.  Nodes are written
        at their full size, 2K children."""
        width = 2 * k
        node_size = 24 + width * (key_size + 8) + key_size
        if children is None:
            return self._append((b'TREE' + bytes([typ, 0]) +
                                 struct.pack('<HQQ', 0, UNDEF, UNDEF) +
                                 empty_key).ljust(node_size, b'\0'))
        level = 0
        while True:
            groups = [children[i:i + width]
                      for i in range(0, len(children), width)]
            base = self._eof
            addrs = [base + i * node_size for i in range(len(groups))]
            blob = b''
            for i, g in enumerate(groups):
                body = b''.join(lk + struct.pack('<Q', c) for lk, c, _ in g)
                body += g[-1][2]
                blob += (b'TREE' + bytes([typ, level]) + struct.pack(
                    '<HQQ', len(g), addrs[i - 1] if i else UNDEF,
                    addrs[i + 1] if i + 1 < len(groups) else UNDEF) +
                    body).ljust(node_size, b'\0')
            self._append(blob)
            if len(groups) == 1:
                return addrs[0]
            children = [(g[0][0], a, g[-1][2]) for g, a in zip(groups, addrs)]
            level += 1

    def _executor(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(min(8, os.cpu_count() or 1))
        return self._pool

    def write_dataset(self, data, chunks=None, attrs=None, enum=None):
        """Append a chunked, shuffled and deflated dataset holding
        ``data`` (numeric, bool, or str/bytes objects as variable-length
        UTF-8 strings; ``enum`` = {name: value} stores integers under an
        enum type); -> its Entry."""
        data = np.asarray(data)
        if data.ndim != 1:
            raise ValueError('writing datasets of rank '
                                     f'{data.ndim}')
        esize = 16 if data.dtype.kind in 'OU' else data.dtype.itemsize
        chunk = (chunks or guess_chunk(data.shape, esize))[0]
        stream = DatasetStream(self, data.dtype, chunk, maxshape=data.shape,
                               enum=enum)
        stream.append(data)
        return stream.close(attrs)

    def stream(self, dtype, chunk, enum=None):
        """A resizable (maxshape None) 1-D dataset written by appends."""
        return DatasetStream(self, dtype, chunk, None, enum)

    def set_root(self, entry):
        """Make the group ``entry`` the file's root group."""
        self._pwrite(self._eof_off, struct.pack('<Q', self._eof))
        self._pwrite(self._root_off, struct.pack(
            '<QQI4xQQ', 0, entry.addr, 1, entry.btree, entry.heap))


class DatasetStream:
    """A 1-D chunked dataset written by :meth:`append`; full chunks are
    shuffled and deflated on the file's thread pool and written in order,
    the last one padded to the full chunk (as HDF5 stores edge chunks).
    :meth:`close` writes the chunk B-tree and the object header."""

    def __init__(self, file, dtype, chunk, maxshape, enum):
        self.file, self.chunk = file, int(chunk)
        self.dtype = np.dtype(dtype)
        self.vlen = self.dtype.kind in 'OU'
        self.esize = 16 if self.vlen else self.dtype.itemsize
        self.maxshape, self.enum = maxshape, enum
        self.n = 0
        self._buf, self._nbuf = [], 0
        self._pending, self._records = [], []

    def append(self, arr):
        arr = np.asarray(arr)
        if self.vlen:
            raw = np.frombuffer(self.file._encode_values(arr), np.uint8)
        else:
            raw = np.frombuffer(np.ascontiguousarray(
                arr.astype(self.dtype, copy=False)).tobytes(), np.uint8)
        self._buf.append(raw)
        self._nbuf += arr.size
        self.n += arr.size
        while self._nbuf >= self.chunk:
            self._emit(self.chunk)

    def _emit(self, count):
        raw = np.concatenate(self._buf) if len(self._buf) > 1 else \
            self._buf[0]
        nb = count * self.esize
        body, rest = raw[:nb].tobytes(), raw[nb:]
        self._buf = [rest] if rest.size else []
        self._nbuf -= count
        body = body.ljust(self.chunk * self.esize, b'\0')
        off = len(self._records) + len(self._pending)
        es = 0 if self.vlen else self.esize
        fut = self.file._executor().submit(
            lambda b=body: zlib.compress(shuffle(b, es) if es else b,
                                         DEFLATE_LEVEL))
        self._pending.append((off * self.chunk, fut))
        while len(self._pending) > 16:
            self._flush_one()

    def _flush_one(self):
        off, fut = self._pending.pop(0)
        data = fut.result()
        addr = self.file._append(data)
        # shuffle is skipped (mask bit 0) for variable-length records, as
        # HDF5's own shuffle declines them
        self._records.append((off, len(data), 1 if self.vlen else 0, addr))

    def close(self, attrs=None):
        f = self.file
        if self._nbuf:
            self._emit(self._nbuf)
        while self._pending:
            self._flush_one()
        key = lambda nbytes, mask, off, es: struct.pack(
            '<IIQQ', nbytes, mask, off, es)
        btree = UNDEF
        if self._records:
            recs = self._records
            children = [(key(nb, m, off, 0), a,
                         key(recs[i + 1][1], recs[i + 1][2], recs[i + 1][0], 0)
                         if i + 1 < len(recs) else
                         key(0, 0, off + self.chunk, self.esize))
                        for i, (off, nb, m, a) in enumerate(recs)]
            btree = f._write_btree(1, children, f._chunk_k, 24, None)
        maxshape = (None,) if self.maxshape is None else self.maxshape
        alloc = struct.pack('<BBBBI', 2, 3, 0 if self.vlen else 2, 1, 0)
        msgs = [(_DATASPACE, 0, _encode_space((self.n,), maxshape)),
                (_DATATYPE, 1, _encode_type(self.dtype, self.enum)),
                (_FILL, 1, alloc),
                (_FILTERS, 1, _encode_filters(0 if self.vlen
                                              else self.esize)),
                (_LAYOUT, 0, struct.pack('<BBBQII', 3, 2, 2, btree,
                                         self.chunk, self.esize))]
        msgs += [(_ATTR, 0, f._attr_message(k, v))
                 for k, v in (attrs or {}).items()]
        return Entry(f._header(msgs), None, None)


CHUNK = 1 << 20


def binnify(chromsizes, res):
    """Fixed-width bin table of ``chromsizes`` ({label: bp}, in order):
    (chrom labels, starts, ends)."""
    chroms, starts, ends = [], [], []
    for c, clen in chromsizes.items():
        n = int(np.ceil(clen / res))
        s = np.arange(n, dtype=np.int64) * res
        chroms.extend([c] * n)
        starts.append(s)
        ends.append(np.minimum(s + res, clen))
    return (np.asarray(chroms, dtype=object), np.concatenate(starts),
            np.concatenate(ends))


def create_cooler(path, chromsizes, res, pixel_chunks, weights,
                  assembly=None, only_intra=True):
    """Write a new single-resolution cooler at ``path`` (its root group):
    the bins of ``chromsizes`` at ``res`` with the float64 ``weights``
    column, and the pixels of ``pixel_chunks`` (dicts of ``bin1_id``,
    ``bin2_id`` and ``count``, sorted by (bin1_id, bin2_id) across the
    chunks), as ``io/coolerlite.create_cooler_file`` writes them;
    ``only_intra`` is the metadata's ``onlyIntra``."""
    bins_chroms, bins_start, bins_end = binnify(chromsizes, res)
    chrom_labels = list(chromsizes)
    chrom_id = {c: i for i, c in enumerate(chrom_labels)}
    bins_chrom = np.asarray([chrom_id[c] for c in bins_chroms], np.int32)
    nbins = len(bins_chrom)
    lengths = np.asarray([int(chromsizes[c]) for c in chrom_labels],
                         np.int32)
    weights = np.asarray(weights, np.float64)
    if weights.shape != (nbins,):
        raise ValueError(f'{weights.shape[0]} weights for {nbins} bins')
    with File(path) as h5:
        chroms = h5.write_group({
            'name': h5.write_dataset(np.array(chrom_labels, dtype=object)),
            'length': h5.write_dataset(lengths)})
        bins_grp = h5.write_group({
            'chrom': h5.write_dataset(bins_chrom, enum=chrom_id),
            'start': h5.write_dataset(np.asarray(bins_start, np.int32)),
            'end': h5.write_dataset(np.asarray(bins_end, np.int32)),
            'weight': h5.write_dataset(weights)})
        cols = {'bin1_id': h5.stream(np.int64, CHUNK),
                'bin2_id': h5.stream(np.int64, CHUNK),
                'count': h5.stream(np.int32, CHUNK)}
        per_bin1 = np.zeros(nbins, np.int64)
        nnz = 0
        total = 0
        for chunk in pixel_chunks:
            b1 = np.asarray(chunk['bin1_id'], np.int64)
            cols['bin1_id'].append(b1)
            cols['bin2_id'].append(np.asarray(chunk['bin2_id'], np.int64))
            ct = np.asarray(chunk['count'])
            cols['count'].append(ct)
            per_bin1 += np.bincount(b1, minlength=nbins)[:nbins]
            nnz += b1.size
            total += float(ct.sum())
        pixels = h5.write_group({k: s.close() for k, s in cols.items()})
        chrom_offset = np.zeros(len(chrom_labels) + 1, dtype=np.int64)
        np.cumsum(np.bincount(bins_chrom, minlength=len(chrom_labels)),
                  out=chrom_offset[1:])
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
            'bin-size': int(res),
            'storage-mode': 'symmetric-upper',
            'nchroms': len(chrom_labels),
            'nbins': nbins,
            'nnz': nnz,
            'sum': total,
            'generated-by': 'portbench',
            'creation-date': '2000-01-01T00:00:00',
        }
        if assembly:
            attrs['genome-assembly'] = assembly
        attrs['metadata'] = json.dumps({'onlyIntra': str(bool(only_intra))})
        h5.set_root(h5.write_group({'chroms': chroms, 'bins': bins_grp,
                                    'pixels': pixels, 'indexes': indexes},
                                   attrs))
