"""Float64 completion of pyHICCUPS's compacted pixels: CUDA kernel
wrappers and their twins.

The kernels are ``csrc/complete64.cu``'s.  :func:`window_stats64`: for
every background and both pixel sets of the fused scorer (the kept pixels
and the lambda-chunk edge suspects), each pixel's float64 O, E, Fold, ICE
and (chunk, count) cell, from the band on the card, in one launch; its
twin for CPU tensors is the host code that completes the other routes,
:func:`hostexact.exact_stats` (the native ring walk of
``csrc/host/bandbuild.cpp``, or numpy's where that walk does not serve)
and :func:`hostexact.chunk_ids64`.  The kernel adds in the native walk's
order and equals the twin bit for bit where that walk serves
(:func:`walks_natively`).  A band on a card always meets its conditions
(the scan kernels take float32 sheets alone, and their shared memory caps
the window radius well below the walk's limit), so the wrapper raises
where they fail instead of completing another way.
:func:`finish64`: the suspects' histogram moves, the BH tables, the
lookups and the audit, one launch; its twin is the host completion's own
table steps (``core/hostcomplete``: ``move_suspects``, ``chunk_qtab``,
``audit``, ``lookup``).
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from . import hostexact

#: The largest window radius, mirrored in csrc/complete64.cu (the native
#: walk's own limit).
MAX_W = 64
_KIND = {'K': 0, 'Y': 1}


@functools.lru_cache(maxsize=None)
def chunk_edges64():
    """numpy's lambda-chunk edges ``2^((k-2)/3)`` for k = 2 .. 3074, computed
    as :func:`hostexact.chunk_ids64` computes them (the last is inf): chunk
    k is the open interval between edges k and k + 1, chunk 1 is (0, 1)."""
    k = np.arange(2, 3075, dtype=np.int64)
    with np.errstate(over='ignore'):
        edges = np.power(2.0, (k - 2) / 3.0)
    edges.flags.writeable = False
    return edges


def plan_meta(plan, bgs):
    """int32 words of the kernel's plan (layout in csrc/complete64.cu): each
    background's (p, kind), then each pool entry's [p, index, n_reads,
    n_bg, reads rings..., bg rings...] in plan order.  ``bgs``: (p, kind)
    a background."""
    words = [v for p, kind in bgs for v in (int(p), _KIND[kind])]
    for e in plan:
        words += [e.p, e.index, len(e.reads_rings), len(e.bg_rings),
                  *e.reads_rings, *e.bg_rings]
    return words


def walks_natively(ctx):
    """Whether ``ctx``'s ring sums are the native walk's, whose order the
    kernel keeps: the whole band as a C-contiguous float32 slab, the
    float64 vectors its size, and a window radius it serves."""
    raw = getattr(ctx.bands, 'raw', None)
    if (not isinstance(raw, np.ndarray) or raw.dtype != np.float32
            or not raw.flags.c_contiguous or raw.ndim != 2):
        return False
    num_p, Lp = raw.shape
    return (ctx.maxw <= MAX_W and np.size(ctx._w64()) == Lp
            and np.size(ctx.bias64()) == Lp and np.size(ctx.ir64()) == num_p)


def window_stats64_twin(ctx, bgs, out):
    """Plain twin of :func:`window_stats64`: :func:`hostexact.exact_stats`
    and ``chunk_ids64`` over each background's pixels of each set, as the
    host completion calls them."""
    _, S, C = out.hist.shape
    O_s = out.sus.O.numpy()
    B, K = len(bgs), out.d.shape[1]
    N = K + out.sus.d.shape[1]
    stats = np.zeros((4, B, N))
    cell = np.full((B, N), -1, np.int32)
    for off, pixels in ((0, out), (K, out.sus)):
        cnt, d, x = (t.numpy() for t in (pixels.cnt, pixels.d, pixels.x))
        for b, (p, kind) in enumerate(bgs):
            n = int(cnt[b])
            got = hostexact.exact_stats(ctx, d[b, :n], x[b, :n], p, kind)
            stats[:, b, off:off + n] = got
            c, valid = hostexact.chunk_ids64(got[1], got[1] > 0)
            count = (np.clip(np.floor(got[0]).astype(np.int64), 0, C - 1)
                     if off == 0 else O_s[b, :n])
            cell[b, off:off + n] = np.where(valid, np.clip(c, 0, S - 1),
                                            0) * C + count
    return torch.from_numpy(stats), torch.from_numpy(cell)


@functools.lru_cache(maxsize=8)
def _meta_on(plan, bgs, device):
    return torch.tensor(plan_meta(plan, bgs), dtype=torch.int32,
                        device=device)


@functools.lru_cache(maxsize=4)
def _edges_on(device):
    return torch.tensor(chunk_edges64(), dtype=torch.float64, device=device)


_STAGING = {}   # device -> (pinned float64 buffer, event after its copy)
_STAGING_LOCK = threading.Lock()


def _vectors_on(ctx, device):
    """w64, bias64, IR64 and the freeze gate as one float64 vector on
    ``device``, copied without blocking the host from one pinned buffer a
    device, kept across calls (a fresh pinned allocation costs
    milliseconds a call)."""
    parts = [ctx._w64(), ctx.bias64(), ctx.ir64(),
             ctx.allowed.astype(np.float64)]
    n = sum(np.size(a) for a in parts)
    with _STAGING_LOCK:
        buf, done = _STAGING.get(device, (None, None))
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.float64, pin_memory=True)
            done = torch.cuda.Event()
        else:
            done.synchronize()      # the last copy out of it has ended
        np.concatenate(parts, out=buf.numpy()[:n])
        with torch.cuda.device(device):
            vec = buf[:n].to(device, non_blocking=True)
            done.record()
        _STAGING[device] = (buf, done)
    return vec


def window_stats64(raw, ctx, bgs, out, lib=None):
    """float64 [4, B, K + Ks] (O, E, Fold, ICE) and int32 [B, K + Ks]
    (chunk, count) cells of each background's kept pixels, then its
    suspects: ``chunk * C + count``, the chunk clipped to [0, S - 1] (0 for
    none), the count the kept pixel's ``clip(floor(O), 0, C - 1)`` and the
    suspect's device count; a slot past its set's count holds zeros and
    cell -1.

    ``raw``: the band [num_p, Lp] on the device; ``ctx``: the chromosome's
    :class:`hostexact.ExactCtx`; ``bgs``: (p, kind) a background; ``out``:
    the batched scorer's ``ops.score.Compacted`` (the pixels and counts of
    both sets, and the histogram's shape).  CPU tensors take the twin;
    CUDA tensors launch the kernel or raise."""
    if raw.device.type == 'cpu':
        return window_stats64_twin(ctx, bgs, out)
    if raw.device.type != 'cuda':
        raise ValueError(f'window_stats64: band on {raw.device}')
    if not walks_natively(ctx) or tuple(raw.shape) != ctx.bands.raw.shape:
        raise ValueError('window_stats64: the card walks the whole float32 '
                         f'band with a radius up to {MAX_W}, as the native '
                         'walk does')
    if raw.dtype != torch.float32 or not raw.is_contiguous():
        raise TypeError('window_stats64: a contiguous float32 band required')
    _, S, C = out.hist.shape
    kept = _contiguous((out.cnt, out.d, out.x))
    sus = _contiguous((out.sus.cnt, out.sus.d, out.sus.x, out.sus.O))
    for t in (*kept, *sus):
        if t.dtype != torch.int32 or t.device != raw.device:
            raise TypeError('window_stats64: int32 counts and indices on '
                            'the band\'s device required')
    if S < 2 or C < 1:
        raise ValueError(f'window_stats64: S={S}, C={C}')
    from ..kernels.build import check, load
    lib = lib or load()
    dev = raw.device
    bgs = tuple((int(p), kind) for p, kind in bgs)
    B, K, Ks = len(bgs), out.d.shape[1], out.sus.d.shape[1]
    meta = _meta_on(tuple(ctx.plan), bgs, dev)
    edges = _edges_on(dev)
    vec = _vectors_on(ctx, dev)
    stats = torch.empty((4, B, K + Ks), dtype=torch.float64, device=dev)
    cell = torch.empty((B, K + Ks), dtype=torch.int32, device=dev)
    num_p, Lp = raw.shape
    bands = ctx.bands
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_complete64(
            raw.data_ptr(), num_p, Lp, int(bands.L), int(bands.ww_min),
            ctx.maxw, vec.data_ptr(), meta.data_ptr(), len(ctx.plan), B,
            *_ptrs(kept), K, *_ptrs(sus), Ks, ctx.thr, edges.data_ptr(),
            edges.numel(), S, C, stats.data_ptr(), cell.data_ptr(), stream)
    check(err, 'window_stats64')
    window_stats64.launches += 1
    return stats, cell


window_stats64.launches = 0


def _contiguous(ts):
    return [t if t.is_contiguous() else t.contiguous() for t in ts]


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def finish64_twin(out, cell, stats, ptab, sig):
    """Plain twin of :func:`finish64`: the host completion's own table
    steps (``core/hostcomplete``), a background at a time."""
    from ..core import hostcomplete as hc
    hist, cell, stats, ptab = (t.numpy()
                               for t in (out.hist, cell, stats, ptab))
    cnt_k, d_k, x_k = (t.numpy() for t in (out.cnt, out.d, out.x))
    cnt_s, d_s, x_s, cid_s, O_s, gap_s, thr = (t.numpy() for t in out.sus)
    B, S, C = hist.shape
    K, N = d_k.shape[1], cell.shape[1]
    rows = np.zeros((B, N, 7))
    fin = np.zeros((B, N), bool)
    head = np.zeros((2, B), np.int64)
    for b in range(B):
        n, ns = int(cnt_k[b]), int(cnt_s[b])
        at = np.r_[0:n, K:K + ns]
        cells = np.divmod(cell[b, at].astype(np.int64), C)
        new = (cells[0][n:], cells[1][n:])
        h = hc.move_suspects(hist[b], (np.clip(cid_s[b, :ns], 0, S - 1),
                                       O_s[b, :ns]), new)
        qtab = hc.chunk_qtab(h, ptab)
        head[1, b] = hc.audit(qtab, h, new, thr[b], sig)
        p, q = hc.lookup(ptab, qtab, cells, cells[0] > 0)
        fin[b, at] = (q <= sig) & ~np.r_[np.zeros(n, bool), gap_s[b, :ns]]
        x = np.r_[x_k[b, :n], x_s[b, :ns]]
        y = x + np.r_[d_k[b, :n], d_s[b, :ns]]
        rows[b, at] = np.stack([x, y, *stats[[0, 3, 2], b][:, at], p, q], -1)
    head[0] = fin.sum(1)
    return (torch.from_numpy(rows.reshape(-1, 7)),
            torch.from_numpy(fin.reshape(-1)), torch.from_numpy(head))


def finish64(out, cell, stats, ptab, sig, lib=None):
    """The BH tables, the lookups and the audit of the batched scorer's
    completion: float64 [B * N, 7] rows (x, y, O, ICE, Fold, p, q), bool
    [B * N] kept, and int64 [2, B]: each background's kept rows and the
    audit's cells (significant below the device's threshold, holding a
    pixel that is not a suspect).  A row is set where it is kept.

    ``out``: the batched scorer's ``ops.score.Compacted``; ``cell`` and
    ``stats``: :func:`window_stats64`'s; ``ptab``: the float64 [S, C] p
    table on the device.  CPU tensors take the twin; CUDA tensors launch
    the kernel or raise."""
    hist, sus = out.hist, out.sus
    if hist.device.type == 'cpu':
        return finish64_twin(out, cell, stats, ptab, sig)
    B, S, C = hist.shape
    kept = (out.cnt, out.d, out.x)
    ints = (hist, cell, *kept, sus.cnt, sus.d, sus.x, sus.cid, sus.O,
            sus.thr)
    if (any(t.dtype != torch.int32 or t.device != hist.device for t in ints)
            or sus.gap.dtype != torch.bool):
        raise TypeError('finish64: int32 histogram, cells, counts and '
                        'indices and bool gap flags on one device required')
    if S < 2 or tuple(ptab.shape) != (S, C) or ptab.dtype != torch.float64:
        raise ValueError(f'finish64: S={S}, a float64 [{S}, {C}] p table '
                         'required')
    from ..kernels.build import check, load
    lib = lib or load()
    dev = hist.device
    hist, cell, stats, ptab = _contiguous((hist, cell, stats, ptab))
    kept, sus = _contiguous(kept), sus._make(_contiguous(sus))
    K, Ks = out.d.shape[1], sus.d.shape[1]
    T = B * (K + Ks)
    h = torch.empty((B, S, C), dtype=torch.int32, device=dev)
    qtab = torch.empty((B, S, C), dtype=torch.float64, device=dev)
    rows = torch.empty((T, 7), dtype=torch.float64, device=dev)
    fin = torch.empty(T, dtype=torch.bool, device=dev)
    head = torch.zeros((2, B), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_finish64(
            hist.data_ptr(), cell.data_ptr(), stats.data_ptr(), B, S, C,
            *_ptrs(kept), K, *_ptrs((sus.cnt, sus.d, sus.x)), Ks,
            *_ptrs((sus.cid, sus.O, sus.gap, sus.thr)),
            ptab.data_ptr(), sig,
            h.data_ptr(), qtab.data_ptr(), rows.data_ptr(), fin.data_ptr(),
            head.data_ptr(), stream)
    check(err, 'finish64')
    finish64.launches += 1
    return rows, fin, head


finish64.launches = 0

