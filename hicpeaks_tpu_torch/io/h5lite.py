"""The subset of HDF5 that cooler files use, read and written with numpy and
the standard library's ``zlib``.

This is the port's only HDF5 code: ``io/coolerlite.py`` reads and writes
coolers through it, so a host without h5py runs toCooler and both peak
callers.  The subset is what h5py writes by default for a cooler
(``libver='earliest'``):

* superblock version 0 (or 1), 8-byte offsets and lengths;
* "old-style" groups: a symbol-table message, a version-1 B-tree of type 0,
  a local heap and ``SNOD`` nodes, B-trees of any depth;
* version-1 object headers with continuation messages;
* datasets with a contiguous or chunked (version-1 B-tree of type 1)
  layout, the chunked ones 1-D, filtered by shuffle and deflate with a
  filter mask per chunk;
* fixed-point, floating-point, fixed- and variable-length string
  (global heap ``GCOL``) and enum types; h5py's bool enum (int8
  ``FALSE``/``TRUE``) reads as ``numpy.bool_``.

Anything else (superblock 2 and 3, version-2 object headers, new-style
groups, other filters, other types) raises :class:`UnsupportedFeature`
naming the feature; nothing is guessed.

Values come back as h5py returns them: numpy arrays for datasets (bytes
objects for variable-length strings), numpy scalars for numeric attributes,
``str`` for variable-length string attributes.

The writer appends: new objects go to the end of the file, and a group whose
members change gets a new B-tree, ``SNOD`` nodes and local heap there.  Its
fixed-size symbol-table message, the cached addresses of its entry in its
parent (or in the superblock, for the root) and the superblock's
end-of-file address are then patched in place.  The old table stays in the
file, unreachable, as the space of a dataset h5py deletes does.  Every
dataset is chunked with shuffle and deflate level 6, with h5py's chunk
guess where no chunk size is given.
"""
from __future__ import annotations

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

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _FILTERS, _ATTR, _CONT, _STAB = 6, 8, 11, 12, 16, 17
_IGNORED = {_NIL, _FILL_OLD, _FILL, 0x000D, 0x000E, 0x0012, 0x0016}
_NEW_STYLE = {_LINK_INFO: 'link info message (new-style group)',
              _LINK: 'link message (new-style group)',
              0x000A: 'group info message (new-style group)',
              0x0015: 'attribute info message (dense attribute storage)',
              0x0018: 'B-tree K values message'}
_FILTER_NAMES = {3: 'fletcher32', 4: 'szip', 5: 'nbit', 6: 'scaleoffset',
                 32000: 'lzf', 32001: 'blosc', 32004: 'lz4',
                 32008: 'bitshuffle', 32015: 'zstd'}
_TYPE_CLASSES = {2: 'time', 4: 'bitfield', 5: 'opaque', 6: 'compound',
                 7: 'reference', 10: 'array'}

Entry = namedtuple('Entry', 'addr btree heap')
"""A written object: its header address and, for a group, its B-tree and
local heap (the addresses a parent's entry caches)."""


class UnsupportedFeature(NotImplementedError):
    """The file uses a part of HDF5 outside the subset this module reads."""


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


def unshuffle(raw, esize):
    n = len(raw) // esize
    if esize <= 1 or n <= 1:
        return raw
    body = np.frombuffer(raw, np.uint8, n * esize).reshape(esize, n)
    out = np.empty((n, esize), np.uint8)
    for j in range(esize):
        out[:, j] = body[j]
    return out.tobytes() + raw[n * esize:]


# --------------------------------------------------------------- datatypes

class _Type:
    """A decoded datatype message: ``kind`` is 'num', 'str' (fixed
    length), 'vlen_str', 'enum' or 'bool'; ``dtype`` is the numpy type
    of one stored element."""

    def __init__(self, kind, dtype):
        self.kind, self.dtype = kind, dtype

    @property
    def size(self):
        return self.dtype.itemsize


def _parse_type(buf, off):
    """-> (_Type, bytes consumed) for the datatype message at ``off``."""
    b0 = buf[off]
    cls, ver = b0 & 0x0F, b0 >> 4
    bits = buf[off + 1] | buf[off + 2] << 8 | buf[off + 3] << 16
    size, = struct.unpack_from('<I', buf, off + 4)
    p = off + 8
    if cls == 0:
        order = '>' if bits & 1 else '<'
        kind = 'i' if bits & 8 else 'u'
        return _Type('num', np.dtype(f'{order}{kind}{size}')), 12
    if cls == 1:
        if bits & 0x40 or size not in (2, 4, 8):
            raise UnsupportedFeature(f'HDF5 float of {size} bytes with '
                                     f'byte-order bits {bits & 0x41:#x}')
        order = '>' if bits & 1 else '<'
        return _Type('num', np.dtype(f'{order}f{size}')), 20
    if cls == 3:
        return _Type('str', np.dtype(f'S{size}')), 8
    if cls == 9:
        if bits & 0x0F != 1:
            raise UnsupportedFeature('HDF5 variable-length sequence type '
                                     '(only variable-length strings)')
        _, used = _parse_type(buf, p)
        return _Type('vlen_str', np.dtype('V16')), 8 + used
    if cls == 8:
        n = bits & 0xFFFF
        base, used = _parse_type(buf, p)
        p += used
        names = []
        for _ in range(n):
            end = buf.index(b'\0', p)
            names.append(bytes(buf[p:end]).decode())
            ln = end + 1 - p
            p += ln + (-ln % 8 if ver < 3 else 0)     # padded before v3
        values = np.frombuffer(bytes(buf[p:p + n * base.size]), base.dtype)
        p += n * base.size
        members = dict(zip(names, values.tolist()))
        kind = 'bool' if (base.size == 1 and
                          members == {'FALSE': 0, 'TRUE': 1}) else 'enum'
        return _Type(kind, base.dtype), p - off
    raise UnsupportedFeature(
        f'HDF5 datatype class {cls} ({_TYPE_CLASSES.get(cls, "unknown")})')


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
            raise UnsupportedFeature(f'writing {dtype}')
        return struct.pack('<BBBBI', 0x11, 0x20, dtype.itemsize * 8 - 1, 0,
                           dtype.itemsize) + props
    if dtype.kind in 'OU':
        return struct.pack('<BBBBI', 0x19, 0x01, 0x01, 0, 16) + \
            struct.pack('<BBBBIHH', 0x10, 0, 0, 0, 1, 0, 8)
    if dtype.kind == 'S':
        return struct.pack('<BBBBI', 0x13, 0, 0, 0, dtype.itemsize)
    raise UnsupportedFeature(f'writing numpy dtype {dtype}')


def _encode_space(shape, maxshape=None):
    if maxshape is None:
        return struct.pack('<BBBBI', 1, len(shape), 0, 0, 0) + \
            struct.pack(f'<{len(shape)}Q', *shape)
    return struct.pack('<BBBBI', 1, len(shape), 1, 0, 0) + \
        struct.pack(f'<{2 * len(shape)}Q', *shape,
                    *(UNDEF if m is None else m for m in maxshape))


def _parse_space(buf, off):
    """-> shape, or None for a null dataspace."""
    ver, rank = buf[off], buf[off + 1]
    if ver == 1:
        p = off + 8
    elif ver == 2:
        if buf[off + 3] == 2:
            return None
        p = off + 4
    else:
        raise UnsupportedFeature(f'HDF5 dataspace message version {ver}')
    return tuple(struct.unpack_from(f'<{rank}Q', buf, p))


def _parse_filters(buf, off):
    ver, n = buf[off], buf[off + 1]
    p = off + (8 if ver == 1 else 2)
    if ver not in (1, 2):
        raise UnsupportedFeature(f'HDF5 filter pipeline version {ver}')
    out = []
    for _ in range(n):
        fid, = struct.unpack_from('<H', buf, p)
        if ver == 1 or fid >= 256:
            name_len, flags, ncd = struct.unpack_from('<HHH', buf, p + 2)
            p += 8
        else:
            name_len = 0
            flags, ncd = struct.unpack_from('<HH', buf, p + 2)
            p += 6
        name = bytes(buf[p:p + name_len]).split(b'\0')[0].decode()
        p += (name_len + (-name_len % 8)) if ver == 1 else name_len
        cd = struct.unpack_from(f'<{ncd}I', buf, p)
        p += 4 * ncd + (4 if ver == 1 and ncd % 2 else 0)
        if fid not in (1, 2):
            raise UnsupportedFeature(
                f'HDF5 filter {fid} '
                f'({name or _FILTER_NAMES.get(fid, "unregistered")})')
        out.append((fid, cd))
    return out


def _encode_filters(esize):
    """Shuffle (over ``esize``-byte elements; none for 0) then deflate 6,
    both optional, as h5py's ``compression='gzip', shuffle=True``."""
    shuf = struct.pack('<HHHH', 2, 8, 1, 1 if esize else 0) + b'shuffle\0'
    if esize:
        shuf += struct.pack('<II', esize, 0)
    defl = struct.pack('<HHHH', 1, 8, 1, 1) + b'deflate\0' + \
        struct.pack('<II', DEFLATE_LEVEL, 0)
    return struct.pack('<BB6x', 1, 2) + shuf + defl


# ----------------------------------------------------------------- objects

class _Object:
    def __init__(self, file, addr, msgs, name):
        self.file, self.addr, self.name = file, addr, name
        self._msgs = msgs

    @property
    def attrs(self):
        """{name: value} in name order, as h5py's ``dict(obj.attrs)``."""
        out = {}
        for t, data_off, data in self._msgs:
            if t == _ATTR:
                name, value = self.file._parse_attr(data)
                out[name] = value
        return dict(sorted(out.items(), key=lambda kv: kv[0].encode()))


class Group(_Object):
    """An old-style group: its members in name order, and attributes."""

    def _table(self):
        for t, off, data in self._msgs:
            if t == _STAB:
                return struct.unpack_from('<QQ', data) + (off,)
        raise UnsupportedFeature(f'{self.name}: group without a symbol-table '
                                 'message')

    def keys(self):
        btree, heap, _ = self._table()
        return [m[0].decode() for m in self.file._members(btree, heap)]

    def __contains__(self, path):
        try:
            self.file._resolve(self._join(path))
        except KeyError:
            return False
        return True

    def _join(self, path):
        return path if path.startswith('/') else \
            self.name.rstrip('/') + '/' + path

    def __getitem__(self, path):
        return self.file[self._join(path)]


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``chunks``, and ``ds[...]``,
    ``ds[lo:hi]`` (1-D) or ``ds[i]`` reads."""

    def __init__(self, file, addr, msgs, name):
        super().__init__(file, addr, msgs, name)
        self._filters = []
        self.chunks = None
        self._layout = None
        for t, _, data in msgs:
            if t == _DATASPACE:
                self.shape = _parse_space(data, 0)
            elif t == _DATATYPE:
                self._type, _ = _parse_type(data, 0)
            elif t == _FILTERS:
                self._filters = _parse_filters(data, 0)
            elif t == _LAYOUT:
                self._layout = self._parse_layout(data)
        if self.shape is None:
            raise UnsupportedFeature(f'{name}: null dataspace')
        t = self._type
        self.dtype = np.dtype(bool) if t.kind == 'bool' else \
            np.dtype(object) if t.kind == 'vlen_str' else t.dtype

    def _parse_layout(self, data):
        ver, cls = data[0], data[1]
        if ver != 3:
            raise UnsupportedFeature(f'{self.name}: HDF5 data layout message '
                                     f'version {ver}')
        if cls == 1:
            return ('contiguous',) + struct.unpack_from('<QQ', data, 2)
        if cls == 2:
            nd = data[2]
            btree, = struct.unpack_from('<Q', data, 3)
            dims = struct.unpack_from(f'<{nd}I', data, 11)
            self.chunks = tuple(dims[:-1])
            return ('chunked', btree, dims)
        raise UnsupportedFeature(f'{self.name}: HDF5 layout class {cls}')

    @property
    def size(self):
        return int(np.prod(self.shape))

    def __getitem__(self, key):
        if key is Ellipsis or (isinstance(key, tuple) and not key) or \
                (isinstance(key, slice) and key == slice(None)):
            return self._convert(self._read(0, self.size)
                                 .reshape(self.shape))
        if len(self.shape) != 1:
            raise UnsupportedFeature(f'{self.name}: partial reads of a '
                                     f'rank-{len(self.shape)} dataset')
        n = self.shape[0]
        if isinstance(key, (int, np.integer)):
            i = int(key) + n if key < 0 else int(key)
            if not 0 <= i < n:
                raise IndexError(f'index {key} out of range for {n}')
            return self._convert(self._read(i, i + 1))[0]
        if isinstance(key, slice) and key.step in (None, 1):
            lo, hi, _ = key.indices(n)
            return self._convert(self._read(lo, max(lo, hi)))
        raise TypeError(f'h5lite reads [...], [i] and [lo:hi], not {key!r}')

    def _convert(self, arr):
        kind = self._type.kind
        if kind == 'bool':
            return arr.astype(bool)
        if kind == 'vlen_str':
            return self.file._vlen_values(arr, as_str=False)
        return arr

    def _read(self, lo, hi):
        """Stored elements [lo, hi) of the flattened dataset."""
        t = self._type
        es = t.size
        if self._layout[0] == 'contiguous':
            addr = self._layout[1]
            if addr == UNDEF:
                return np.zeros(hi - lo, t.dtype)
            raw = self.file._pread(addr + lo * es, (hi - lo) * es)
            return np.frombuffer(raw, t.dtype).copy()
        if len(self.shape) != 1:
            raise UnsupportedFeature(f'{self.name}: chunked dataset of rank '
                                     f'{len(self.shape)}')
        _, btree, dims = self._layout
        c = dims[0]
        out = np.zeros(hi - lo, t.dtype)
        if hi <= lo or btree == UNDEF:
            return out
        records = self.file._chunk_records(btree, len(dims), lo - lo % c, hi)

        def load(rec):
            off, nbytes, mask, addr = rec
            raw = self.file._pread(addr, nbytes)
            for i in reversed(range(len(self._filters))):
                if mask >> i & 1:
                    continue
                fid, cd = self._filters[i]
                if fid == 1:
                    raw = zlib.decompress(raw, 15, c * es)
                else:
                    raw = unshuffle(raw, cd[0] if cd else es)
            a, b = max(off, lo), min(off + c, hi)
            out[a - lo:b - lo] = np.frombuffer(raw, t.dtype, b - a,
                                               (a - off) * es)

        if len(records) > 1:
            with ThreadPoolExecutor(min(len(records),
                                        os.cpu_count() or 1)) as ex:
                list(ex.map(load, records))
        else:
            for rec in records:
                load(rec)
        return out


# -------------------------------------------------------------------- file

class File:
    """An HDF5 file opened 'r', 'r+' or 'w' (a new file with an empty
    root group; an existing one is truncated)."""

    def __init__(self, path, mode='r'):
        if mode not in ('r', 'r+', 'w'):
            raise ValueError(f'mode {mode!r}: h5lite opens "r", "r+", "w"')
        flags = {'r': os.O_RDONLY, 'r+': os.O_RDWR,
                 'w': os.O_RDWR | os.O_CREAT | os.O_TRUNC}[mode]
        self.path, self.mode = path, mode
        self._fd = os.open(path, flags, 0o644)
        self._gheaps = {}
        self._gcol = None           # the writer's collection: [addr, size, used, idx]
        self._pool = None
        try:
            if mode == 'w':
                self._create()
            else:
                self._read_superblock()
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
            if self.mode != 'r':
                self._pwrite(self._eof_off, struct.pack('<Q', self._eof))
        finally:
            os.close(self._fd)
            self._fd = None

    # ---- low level
    def _pread(self, addr, n):
        data = os.pread(self._fd, n, addr)
        if len(data) < n:
            raise OSError(f'{self.path}: truncated (read of {n} bytes at '
                          f'{addr} got {len(data)})')
        return data

    def _pwrite(self, addr, data):
        os.pwrite(self._fd, data, addr)

    def _append(self, data):
        addr = self._eof
        self._pwrite(addr, data)
        self._eof += len(data)
        return addr

    def _read_superblock(self):
        buf = self._pread(0, 96)
        if buf[:8] != SIGNATURE:
            raise OSError(f'{self.path}: not an HDF5 file (no signature at '
                          'offset 0)')
        ver = buf[8]
        if ver > 1:
            raise UnsupportedFeature(
                f'{self.path}: HDF5 superblock version {ver} (written with '
                'libver "v108" or later); h5lite reads versions 0 and 1')
        if buf[13] != 8 or buf[14] != 8:
            raise UnsupportedFeature(f'{self.path}: offsets of {buf[13]} and '
                                     f'lengths of {buf[14]} bytes')
        self._leaf_k, self._group_k = struct.unpack_from('<HH', buf, 16)
        p = 24
        self._chunk_k = _CHUNK_K
        if ver == 1:
            self._chunk_k, = struct.unpack_from('<H', buf, 24)
            p = 28
            buf = self._pread(0, 104)
        base, _, eof, _ = struct.unpack_from('<4Q', buf, p)
        if base != 0:
            raise UnsupportedFeature(f'{self.path}: base address {base} '
                                     '(a user block)')
        self._eof_off, self._eof = p + 16, eof
        self._root_off = p + 32

    def _create(self):
        self._leaf_k, self._group_k, self._chunk_k = \
            _LEAF_K, _GROUP_K, _CHUNK_K
        self._eof_off, self._root_off, self._eof = 40, 56, 96
        self._pwrite(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) +
                     struct.pack('<HHI4Q', _LEAF_K, _GROUP_K, 0, 0, UNDEF, 96,
                                 UNDEF) + b'\0' * 40)
        self.set_root(self.write_group({}))

    # ---- object headers
    def _messages(self, addr):
        """[(type, file offset of the data, data)] of the v1 header at
        ``addr``, continuation blocks followed."""
        pre = self._pread(addr, 16)
        if pre[:4] == b'OHDR':
            raise UnsupportedFeature(f'{self.path}: version-2 object header '
                                     f'at {addr}')
        if pre[0] != 1:
            raise UnsupportedFeature(f'{self.path}: object header version '
                                     f'{pre[0]} at {addr}')
        size, = struct.unpack_from('<I', pre, 8)
        blocks, msgs = [(addr + 16, size)], []
        while blocks:
            start, n = blocks.pop(0)
            buf = self._pread(start, n)
            p = 0
            while p + 8 <= n:
                t, sz, flags = struct.unpack_from('<HHB', buf, p)
                data = buf[p + 8:p + 8 + sz]
                if flags & 2:
                    raise UnsupportedFeature(f'{self.path}: shared object '
                                             f'header message (type {t})')
                if t == _CONT:
                    blocks.append(struct.unpack_from('<QQ', data))
                elif t in _NEW_STYLE:
                    raise UnsupportedFeature(f'{self.path}: '
                                             f'{_NEW_STYLE[t]}')
                elif t not in _IGNORED:
                    msgs.append((t, start + p + 8, data))
                p += 8 + sz
        return msgs

    def _parse_attr(self, data):
        ver = data[0]
        if ver not in (1, 2, 3):
            raise UnsupportedFeature(f'attribute message version {ver}')
        if ver > 1 and data[1] & 3:
            raise UnsupportedFeature('shared attribute datatype or dataspace')
        name_n, type_n, space_n = struct.unpack_from('<HHH', data, 2)
        p = 8 if ver < 3 else 9
        pad = (lambda n: n + (-n % 8)) if ver == 1 else (lambda n: n)
        name = bytes(data[p:p + name_n]).split(b'\0')[0].decode()
        p += pad(name_n)
        t, _ = _parse_type(data, p)
        p += pad(type_n)
        shape = _parse_space(data, p)
        p += pad(space_n)
        if shape is None:
            raise UnsupportedFeature(f'attribute {name!r}: null dataspace')
        n = int(np.prod(shape))
        arr = np.frombuffer(bytes(data[p:p + n * t.size]), t.dtype)
        if t.kind == 'vlen_str':
            arr = self._vlen_values(arr, as_str=True)
        elif t.kind == 'bool':
            arr = arr.astype(bool)
        else:
            arr = arr.copy()
        if shape == ():
            return name, arr[0]
        return name, arr.reshape(shape)

    def _vlen_values(self, records, as_str):
        out = np.empty(records.shape, object)
        raw = records.tobytes()
        for i in range(records.size):
            n, addr, idx = struct.unpack_from('<IQI', raw, 16 * i)
            b = self._gheap(addr)[idx][:n] if n else b''
            out.flat[i] = b.decode() if as_str else b
        return out

    def _gheap(self, addr):
        if addr not in self._gheaps:
            head = self._pread(addr, 16)
            if head[:4] != b'GCOL':
                raise OSError(f'{self.path}: no global heap at {addr}')
            size, = struct.unpack_from('<Q', head, 8)
            buf = self._pread(addr, size)
            objs, p = {}, 16
            while p + 16 <= size:
                idx, _, n = struct.unpack_from('<HH4xQ', buf, p)
                if idx == 0:
                    break
                objs[idx] = buf[p + 16:p + 16 + n]
                p += 16 + n + (-n % 8)
            self._gheaps[addr] = objs
        return self._gheaps[addr]

    # ---- groups
    def _node(self, addr, key_size):
        """(type, level, [keys], [children]) of a v1 B-tree node."""
        head = self._pread(addr, 24)
        if head[:4] != b'TREE':
            if head[:4] == b'BTHD':
                raise UnsupportedFeature(f'{self.path}: version-2 B-tree')
            raise OSError(f'{self.path}: no B-tree node at {addr}')
        typ, level, n = head[4], head[5], struct.unpack_from('<H', head, 6)[0]
        buf = self._pread(addr + 24, n * (key_size + 8) + key_size)
        step = key_size + 8
        keys = [buf[i * step:i * step + key_size] for i in range(n + 1)]
        kids = [struct.unpack_from('<Q', buf, i * step + key_size)[0]
                for i in range(n)]
        return typ, level, keys, kids

    def _members(self, btree, heap):
        """[(name bytes, entry offset, header addr, cache type, scratch)]
        of a group, in name order."""
        hbuf = self._pread(heap, 32)
        if hbuf[:4] != b'HEAP':
            raise OSError(f'{self.path}: no local heap at {heap}')
        dsize, _, daddr = struct.unpack_from('<QQQ', hbuf, 8)
        names = self._pread(daddr, dsize)
        out = []

        def walk(addr):
            typ, level, _, kids = self._node(addr, 8)
            for kid in kids:
                if level:
                    walk(kid)
                    continue
                sn = self._pread(kid, 8 + 40 * 2 * self._leaf_k)
                if sn[:4] != b'SNOD':
                    raise OSError(f'{self.path}: no symbol node at {kid}')
                for i in range(struct.unpack_from('<H', sn, 6)[0]):
                    e = 8 + 40 * i
                    noff, haddr, ctype = struct.unpack_from('<QQI', sn, e)
                    name = names[noff:names.index(b'\0', noff)]
                    out.append((name, kid + e, haddr, ctype,
                                sn[e + 24:e + 40]))
        walk(btree)
        return out

    def _resolve(self, path):
        """-> (entry offset, header addr, name) of ``path``; KeyError if
        absent."""
        off = self._root_off
        addr, = struct.unpack_from('<Q', self._pread(off + 8, 8))
        name = '/'
        for comp in (c for c in path.split('/') if c):
            grp = Group(self, addr, self._messages(addr), name)
            btree, heap, _ = grp._table()
            for m in self._members(btree, heap):
                if m[0] == comp.encode():
                    off, addr = m[1], m[2]
                    break
            else:
                raise KeyError(f'{path!r} not in {self.path}')
            name = name.rstrip('/') + '/' + comp
        return off, addr, name

    def __getitem__(self, path):
        _, addr, name = self._resolve(path)
        msgs = self._messages(addr)
        if any(t == _STAB for t, _, _ in msgs):
            return Group(self, addr, msgs, name)
        if any(t == _LAYOUT for t, _, _ in msgs):
            return Dataset(self, addr, msgs, name)
        raise UnsupportedFeature(f'{self.path}:{name}: object that is '
                                 'neither an old-style group nor a dataset')

    def __contains__(self, path):
        return path in self['/']

    # ---- chunk index
    def _chunk_records(self, btree, ndims, lo, hi):
        """[(offset, nbytes, filter mask, addr)] of the chunks of a 1-D
        dataset whose offsets lie in [lo, hi), visiting only the subtrees
        that can hold them.  A child's right key may equal its last
        chunk's offset (HDF5 writes it so), so both ends are inclusive."""
        key_size = 8 + 8 * ndims
        out = []

        def walk(addr):
            _, level, keys, kids = self._node(addr, key_size)
            offs = [struct.unpack_from('<Q', k, 8)[0] for k in keys]
            for i, kid in enumerate(kids):
                if level:
                    if offs[i + 1] >= lo and offs[i] < hi:
                        walk(kid)
                elif lo <= offs[i] < hi:
                    nbytes, mask = struct.unpack_from('<II', keys[i])
                    out.append((offs[i], nbytes, mask, kid))
        walk(btree)
        return out

    # ---------------------------------------------------------- writing
    def _writable(self):
        if self.mode == 'r':
            raise OSError(f'{self.path} is open read-only')

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
        self._gheaps.pop(addr, None)
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
        self._writable()
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
        self._writable()
        data = np.asarray(data)
        if data.ndim != 1:
            raise UnsupportedFeature('writing datasets of rank '
                                     f'{data.ndim}')
        esize = 16 if data.dtype.kind in 'OU' else data.dtype.itemsize
        chunk = (chunks or guess_chunk(data.shape, esize))[0]
        stream = DatasetStream(self, data.dtype, chunk, maxshape=data.shape,
                               enum=enum)
        stream.append(data)
        return stream.close(attrs)

    def stream(self, dtype, chunk, enum=None):
        """A resizable (maxshape None) 1-D dataset written by appends."""
        self._writable()
        return DatasetStream(self, dtype, chunk, None, enum)

    def entries(self, path):
        """{name: Entry} of the members of the group at ``path``, to carry
        into a new group."""
        grp = self[path]
        btree, heap, _ = grp._table()
        return {n.decode(): Entry(addr, *(struct.unpack('<QQ', scratch)
                                          if ctype == 1 else (None, None)))
                for n, _, addr, ctype, scratch in self._members(btree, heap)}

    def set_root(self, entry):
        """Make the group ``entry`` the file's root group."""
        self._writable()
        self._pwrite(self._eof_off, struct.pack('<Q', self._eof))
        self._pwrite(self._root_off, struct.pack(
            '<QQI4xQQ', 0, entry.addr, 1, entry.btree, entry.heap))

    def link(self, path, members):
        """Add ``members`` ({name: Entry}, replacing any of the same
        name) to the group at ``path``.  The group gets a new table at the
        end of the file; its symbol-table message, its entry's cached
        addresses and the end-of-file address are patched in place."""
        self._writable()
        entry_off, addr, name = self._resolve(path)
        stab_off = Group(self, addr, self._messages(addr), name)._table()[2]
        btree, heap = self._write_table({**self.entries(path), **members})
        self._pwrite(self._eof_off, struct.pack('<Q', self._eof))
        self._pwrite(stab_off, struct.pack('<QQ', btree, heap))
        ctype, = struct.unpack_from('<I', self._pread(entry_off + 16, 4))
        if ctype == 1:
            self._pwrite(entry_off + 24, struct.pack('<QQ', btree, heap))


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
