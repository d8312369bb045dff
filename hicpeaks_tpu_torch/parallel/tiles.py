"""Band tiles with halos over a device list.

Port of ``hicpeaks_tpu/parallel/tiles.py``.  The genome axis of each band
sheet is cut into equal column tiles, tile i on ``mesh.devices[i]``.  The
ring scan is a +-maxww stencil, so each tile's kernels run on a slab with
``H = 2 * maxww`` halo columns from each neighbour (zeros at the
chromosome's ends, the reference's zero padding, callers.py:53-54); the
candidate mask's halo is zero, because halo pixels belong to the
neighbouring tile.  The kernels take one contiguous tensor on one device,
so every halo-extended slab is a ``torch.cat``.

JAX's collectives become:

* ``ppermute`` (the halo exchange): a copy between devices within a
  process; a ``torch.distributed`` send and receive across processes
  (``parallel/launch.device_transport``);
* ``psum``: the per-tile tensors summed on the mesh's first device in
  tile order (:func:`psum`), then an ``all_reduce`` across processes.  The
  sums the scans and the histogram take are integer counts, so they are
  exact.

A sharded sheet is a list with one entry per tile: the tile's tensor for
this process's tiles, None for other processes' tiles.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.spans import SYNC, span
from ..ops import cuda_hist, cuda_scan
from ..ops import score as score_ops
from .launch import device_transport


def tile_width(Lp, n):
    """Columns per tile: ``Lp`` padded up to a multiple of ``n`` tiles."""
    return -(-Lp // n)


def shard_band(arr, mesh):
    """Cut a [..., Lp] tensor into the mesh's column tiles (JAX
    ``tiles.py:37-45``): zero columns pad ``Lp`` up to a multiple of the
    tile count, and tile i becomes a contiguous tensor on
    ``mesh.devices[i]`` (None for other processes' tiles)."""
    n = mesh.size
    T = tile_width(arr.shape[-1], n)
    pad = T * n - arr.shape[-1]
    if pad:
        arr = torch.cat([arr, arr.new_zeros(arr.shape[:-1] + (pad,))], -1)
    return [arr[..., i * T:(i + 1) * T].to(mesh.devices[i]).contiguous()
            if mesh.is_local(i) else None for i in range(n)]


def halo_width(plan):
    """JAX's halo ``H = 2 * max(e.w)`` (``tiles.py:163,206``), checked to
    cover the columns the kernels read, ``cuda_scan.max_ring(plan)``."""
    H = 2 * max(e.w for e in plan)
    if H < cuda_scan.max_ring(plan):
        raise AssertionError(f'halo {H} is narrower than the kernels\' reach '
                             f'{cuda_scan.max_ring(plan)}')
    return H


def _wire(t, transport):
    """``t`` as it travels on the transport: NCCL takes device tensors,
    gloo host tensors; bools travel as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if transport == 'nccl':
        return t.contiguous()
    with span(SYNC):
        return t.cpu().contiguous()


def _exchange(tiles, H, mesh, left, right):
    """Fill ``left[i]``/``right[i]`` for each local tile whose neighbour
    belongs to another process: one batch of sends and receives.  The tag
    of a tile's last H columns is 2*i, of its first H columns 2*i + 1."""
    transport, group = device_transport()
    ops, recvs = [], []
    for i in mesh.local_tiles:
        for j, side in ((i + 1, 'right'), (i - 1, 'left')):
            if not 0 <= j < mesh.size or mesh.is_local(j):
                continue
            peer = mesh.owners[j]
            piece = tiles[i][..., -H:] if side == 'right' else \
                tiles[i][..., :H]
            send = _wire(piece, transport)
            buf = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send, peer, group,
                                  tag=2 * i + (side == 'left')))
            ops.append(dist.P2POp(dist.irecv, buf, peer, group,
                                  tag=2 * j + (side == 'right')))
            recvs.append((i, side, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i, side, buf in recvs:
        got = buf.to(mesh.devices[i]).to(tiles[i].dtype)
        (right if side == 'right' else left)[i] = got


def _with_halo(tiles, H, mesh):
    """Each local tile with H columns of its left and right neighbours
    attached, zeros beyond the chromosome's ends (JAX ``_with_halo``)."""
    n = mesh.size
    for i in mesh.local_tiles:
        if tiles[i].shape[-1] < H:
            raise ValueError(f'tiles of {tiles[i].shape[-1]} columns are '
                             f'narrower than the {H}-column halo; use fewer '
                             'tiles')
    left, right = [None] * n, [None] * n
    for i in mesh.local_tiles:
        dev = mesh.devices[i]
        if i > 0 and mesh.is_local(i - 1):
            left[i] = tiles[i - 1][..., -H:].to(dev)
        if i < n - 1 and mesh.is_local(i + 1):
            right[i] = tiles[i + 1][..., :H].to(dev)
    if mesh.spans_processes:
        _exchange(tiles, H, mesh, left, right)
    out = [None] * n
    for i in mesh.local_tiles:
        x = tiles[i]
        zero = x.new_zeros(x.shape[:-1] + (H,))
        l = zero if left[i] is None else left[i]
        r = zero if right[i] is None else right[i]
        out[i] = torch.cat([l, x, r], -1)
    return out


def _zero_halo(tiles, H):
    """Each tile with H zero columns on each side."""
    out = []
    for x in tiles:
        if x is None:
            out.append(None)
            continue
        zero = x.new_zeros(x.shape[:-1] + (H,))
        out.append(torch.cat([zero, x, zero], -1))
    return out


def _all_reduce(t):
    transport, group = device_transport()
    if transport == 'nccl':
        dist.all_reduce(t, group=group)
        return t
    with span(SYNC):
        h = t.cpu().clone()
    dist.all_reduce(h)
    return h.to(t.device)


def psum(parts, mesh):
    """The sum of the per-tile tensors ``parts`` (None for other processes'
    tiles) on the mesh's first local device, added in tile order; across
    processes an ``all_reduce`` of each process's sum (JAX ``psum``)."""
    dev = mesh.first_device
    total = None
    for p in parts:
        if p is None:
            continue
        total = p.to(dev) if total is None else total + p.to(dev)
    if mesh.spans_processes:
        total = _all_reduce(total)
    return total


def gather_tiles(tiles, mesh):
    """The whole sheet on the mesh's first local device: the tiles
    concatenated in column order; a tile of another process comes by a
    broadcast from its owner, so every process of a global mesh gets the
    whole sheet."""
    dev = mesh.first_device
    if not mesh.spans_processes:
        return torch.cat([t.to(dev) for t in tiles], -1)
    transport, group = device_transport()
    ref = tiles[mesh.local_tiles[0]]
    parts = []
    for i in range(mesh.size):
        buf = _wire(tiles[i] if mesh.is_local(i) else ref, transport)
        if not mesh.is_local(i):
            buf = torch.empty_like(buf)
        dist.broadcast(buf, src=mesh.owners[i], group=group)
        parts.append(buf.to(dev).to(ref.dtype))
    return torch.cat(parts, -1)


def ir_sharded(raw_tiles, w0, nanw, L, ww_min, num, mesh):
    """Per-diagonal NaN-aware means (``ops/band.build_bands``' ``IR``) from
    the tile-sharded raw slab with one :func:`psum` (JAX ``tiles.py:
    66-125``): the balanced diagonal sum counts structural zeros in the
    denominator, subtracts only nonzero pixels whose weight product is
    NaN, divides with IEEE propagation (0/0 -> nan), and zeroes rows
    ``< ww_min`` and ``>= num``.

    ``w0``/``nanw`` are the whole chromosome's vectors (numpy or tensors).
    Returns the [num_p] vector on the mesh's first device in ``w0``'s
    dtype; the float sums add tile by tile, so it agrees with the host
    builder's to rounding (rtol 1e-12 in float64), not bit for bit."""
    csums, nans = [None] * mesh.size, [None] * mesh.size
    num_p = None
    for i in mesh.local_tiles:
        raw = raw_tiles[i]
        dev = raw.device
        num_p, T = raw.shape
        c0 = i * T
        w = torch.as_tensor(w0).to(dev)
        nw = torch.as_tensor(nanw).to(dev)
        wx = score_ops._cols(w, c0, T)[None, :]
        wxd = score_ops.shear_bcast(w, num_p, c0, T)         # w[c0+i+d]
        nx = score_ops._cols(nw, c0, T)[None, :]
        nxd = score_ops.shear_bcast(nw, num_p, c0, T)
        cb = raw.to(w.dtype) * wx * wxd
        csums[i] = cb.sum(dim=1)
        nans[i] = ((raw != 0) & (nx | nxd)).sum(dim=1)
    csum = psum(csums, mesh)
    nancnt = psum(nans, mesh)
    d = torch.arange(num_p, device=csum.device)
    denom = torch.clamp(L - d, min=0).to(csum.dtype) - nancnt
    IR = csum / denom
    return torch.where((d < ww_min) | (d >= num), 0.0, IR)


def chunk_hist_sharded(O_tiles, cid_tiles, valid_tiles, S, C, mesh):
    """The exact int32 [B*S, C] (chunk, count) histogram of a sharded
    sheet (JAX ``tiles.py:128-146``): each tile packs its own pixels
    (``ops/score.chunk_pack``), launches the histogram kernel
    (``cuda_hist.chunk_hist``) and the tiles' histograms are summed.
    Packing is order-free, so per-tile packing changes nothing but the
    trash cell (0, 0)."""
    parts = [None] * mesh.size
    for i in mesh.local_tiles:
        oc, cid0 = score_ops.chunk_pack(O_tiles[i], cid_tiles[i],
                                        valid_tiles[i], S, C)
        parts[i] = cuda_hist.chunk_hist(oc, cid0, S, C)
    return psum(parts, mesh)


def scan_pass_a_sharded(raw, cand, plan, p_list, thr, mesh, pass_a=None):
    """Freeze-count pass on every tile's halo-extended slab (pass A kernel,
    ``pass_a`` default ``cuda_scan.scan_pass_a``), the counts summed:
    int32 [len(plan)] on the mesh's first device (JAX ``tiles.py:
    158-198``)."""
    pass_a = pass_a or cuda_scan.scan_pass_a
    H = halo_width(plan)
    raw_e = _with_halo(raw, H, mesh)
    cand_e = _zero_halo(cand, H)
    counts = [None] * mesh.size
    for i in mesh.local_tiles:
        counts[i] = pass_a(raw_e[i], cand_e[i], plan, p_list, thr)
    return psum(counts, mesh)


def scan_pass_b_sharded(raw, cband, eband, cand, allowed, plan, p_list, thr,
                        mesh, pass_b=None):
    """Capture pass on every tile's halo-extended slabs (pass B kernel,
    ``pass_b`` default ``cuda_scan.scan_pass_b``) under the bool
    [len(plan)] gate ``allowed``; each tile's captures are cropped by H on
    each side (JAX ``tiles.py:202-264``).  Returns, per tile, {p: [KS, KE,
    YS, YE]} of contiguous [num_p, T] tensors (None for other processes'
    tiles)."""
    pass_b = pass_b or cuda_scan.scan_pass_b
    H = halo_width(plan)
    raw_e = _with_halo(raw, H, mesh)
    cband_e = _with_halo(cband, H, mesh)
    eband_e = _with_halo(eband, H, mesh)
    cand_e = _zero_halo(cand, H)
    outs = [None] * mesh.size
    for i in mesh.local_tiles:
        o = pass_b(raw_e[i], cband_e[i], eband_e[i], cand_e[i],
                   allowed.to(mesh.devices[i]), plan, p_list, thr)
        outs[i] = {p: [v[:, H:-H].contiguous() for v in caps]
                   for p, caps in o.items()}
        del o
    return outs


def _all_gather_host(obj, mesh):
    """Every process's ``obj`` in rank order (gloo); [obj] on a local
    mesh."""
    if not mesh.spans_processes:
        return [obj]
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def merge_rowmajor(parts, mesh):
    """Merge per-tile compactions into the whole chromosome's row-major
    order over [d, x].

    ``parts``: for each local tile, (c0, [per background (d, x, *values)]
    host arrays, x tile-local).  Tile order is not row-major, so the
    entries are sorted on (d, x + c0); every process of a global mesh gets
    every tile's entries.  Returns, per background, (d, x, *values) with
    chromosome columns."""
    every = [t for got in _all_gather_host(parts, mesh) for t in got]
    n_bg = len(every[0][1])
    merged = []
    for b in range(n_bg):
        cols = list(zip(*[(bgs[b][0], bgs[b][1] + c0) + tuple(bgs[b][2:])
                          for c0, bgs in every]))
        cols = [np.concatenate(c) for c in cols]
        order = np.lexsort((cols[1], cols[0]))
        merged.append(tuple(c[order] for c in cols))
    return merged


class TiledSheet:
    """A sheet kept as per-tile [..., num_p, T] tensors, for reads of a
    few pixels (the pyHICCUPS postcheck of ``prod``)."""

    def __init__(self, tiles, mesh):
        self.tiles = tiles
        self.mesh = mesh
        self.T = tiles[mesh.local_tiles[0]].shape[-1]

    def gather(self, lead, d, x):
        """sheet[lead][d, x] for chromosome columns ``x``, as float64
        numpy: each process reads the pixels of its own tiles, and a
        global mesh exchanges them over gloo."""
        d = np.asarray(d, np.int64)
        x = np.asarray(x, np.int64)
        tile = x // self.T
        found = []
        for i in self.mesh.local_tiles:
            at = np.nonzero(tile == i)[0]
            if at.size == 0:
                continue
            t = self.tiles[i]
            di = torch.as_tensor(d[at], device=t.device)
            xi = torch.as_tensor(x[at] - i * self.T, device=t.device)
            vals = t[lead][di, xi].double()
            with span(SYNC):
                found.append((at, vals.cpu().numpy()))
        out = np.zeros(d.shape[0], np.float64)
        for got in _all_gather_host(found, self.mesh):
            for at, vals in got:
                out[at] = vals
        return out
