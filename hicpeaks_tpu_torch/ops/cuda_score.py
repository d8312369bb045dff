"""The batched pyHICCUPS scorer's dense float32 stages: CUDA kernel
wrappers and their twins.

The kernels are ``csrc/score_fused.cu``'s; no TPU kernel computes these
stages (the JAX package leaves ``expected_observed``, ``lambda_chunks``,
``chunk_pack``, ``chunk_keep`` and ``lambda_suspects`` to XLA).  In the
eager chain (:mod:`.score`) they are dozens of full-size torch ops over
[B, num_p, Lp] stacks; here they are:

* :func:`score_observe`: one pass over the band for all B backgrounds, reading
  each background's pass-B capture planes in place: the histogram's
  inputs (the shared count and each background's chunk id) and a flag
  byte a background (:data:`SCORED`, :data:`VALID`, :data:`SUSPECT`);
* :func:`score_keep`: after the histogram and its thresholds, the keep mask and
  the lambda-chunk edge suspects' mask;
* :func:`score_gather`: the values of a few pixels (the compactions' and the
  postcheck's), recomputed from the same planes in the same order, so no
  dense E, Fold, chunk or prod sheet is written (:class:`PlaneProd` is the
  postcheck's handle on prod, read through :func:`score_prod`).

Each kernel's values are its twin's bit for bit; the twins are the eager
chain itself, which CPU tensors take.  The engine runs the kernels where
:func:`serves` says so, and the eager chain everywhere else.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..core.spans import SYNC, span
from . import score as score_ops

#: Backgrounds a launch takes (mirrored in csrc/score_fused.cu), and the
#: chunk ids of its edge table.
MAX_B = 64
N_EDGES = 512
#: Flag bits of :func:`score_observe`.
SCORED, VALID, SUSPECT = 1, 2, 4
_LN2 = float(np.float32(math.log(2.0)))


def serves(sh, SV, EV, check):
    """Whether the kernels score this chromosome: a CUDA device, float32
    sheets and planes, at most :data:`MAX_B` backgrounds and no checkify
    (whose checks read the dense E, O, ICE and Fold)."""
    return (not check and sh.raw.device.type == 'cuda'
            and 0 < len(SV) <= MAX_B
            and all(t.dtype == torch.float32 for t in
                    (sh.raw, sh.cband, sh.IR, sh.Bprod, *SV, *EV)))


def _stacked(sh, SV, EV, wis):
    """The eager chain's first stage over the stacked planes."""
    wis_t = torch.tensor(wis, dtype=torch.int32, device=sh.raw.device)
    return score_ops.expected_observed(
        sh.raw, sh.cband, sh.IR, sh.Bprod, torch.stack(SV), torch.stack(EV),
        wis_t[:, None, None], sh.cand, sh.L)


def score_observe_twin(sh, SV, EV, wis, margin, S, C):
    """Plain twin of :func:`score_observe`: the eager chain's chunk ids, counts
    and masks."""
    E, O, _ICE, _Fold, scored, _prod = _stacked(sh, SV, EV, wis)
    cid, _rv, valid = score_ops.lambda_chunks(E, scored)
    sus = score_ops.lambda_suspects(E, scored, margin)
    oc, cid0 = score_ops.chunk_pack(O, cid, valid, S, C)
    flags = (scored.to(torch.uint8) * SCORED + valid.to(torch.uint8) * VALID
             + sus.to(torch.uint8) * SUSPECT)
    return oc, cid0, flags.reshape(len(SV), -1)


def score_keep_twin(raw, gap_drop, cid0, flags, thr2, sig, C, exact):
    """Plain twin of :func:`score_keep`: ``chunk_keep`` and the gap filter, the
    suspects set aside in ``exact`` mode."""
    shape = (cid0.shape[0],) + tuple(raw.shape)
    scored, valid, sus = ((flags & bit).reshape(shape) != 0
                          for bit in (SCORED, VALID, SUSPECT))
    kept = scored & score_ops.chunk_keep(raw, cid0.reshape(shape), valid,
                                         thr2, sig, C) & ~gap_drop
    return (kept & ~sus, sus) if exact else (kept, None)


def score_gather_twin(sh, SV, EV, wis, kept, sus, C, prod=True):
    """Plain twin of :func:`score_gather`: the eager chain's sheets,
    gathered."""
    E, O, ICE, Fold, scored, prod_sheet = _stacked(sh, SV, EV, wis)
    cid, _rv, valid = score_ops.lambda_chunks(E, scored)
    cid = torch.where(valid, cid, 0)
    Lp = O.shape[1]

    def at(a, d, x):
        flat = d.to(torch.int64) * Lp + x
        if a.dim() == 2:
            return a.reshape(-1)[flat]
        return torch.gather(a.reshape(a.shape[0], -1), 1, flat)
    got = ()
    if kept is not None:
        d, x = kept
        got += (at(O, d, x), at(ICE, d, x), at(Fold, d, x), at(cid, d, x))
    if sus is not None:
        d, x = sus
        count = torch.clamp(torch.floor(at(O, d, x)), 0, C - 1) \
            .to(torch.int32)
        got += (at(cid, d, x), count, at(sh.gap_drop, d, x))
        if prod:
            got += (at(prod_sheet, d, x),)
    return got


def _library():
    from ..kernels.build import load
    return load()


def _common(sh):
    for t in (sh.raw, sh.Bprod, sh.cand, sh.IR, sh.cband, sh.gap_drop):
        if not t.is_contiguous() or t.device != sh.raw.device:
            raise ValueError('score kernels: contiguous sheets on one device '
                             'required')
    num_p, Lp = sh.raw.shape
    return (sh.raw.data_ptr(), sh.Bprod.data_ptr(), sh.cand.data_ptr(),
            sh.IR.data_ptr()), num_p, Lp


def _planes(sh, SV, EV, wis):
    """Host arrays of the planes' device pointers and the radii."""
    B = len(SV)
    if not 0 < B <= MAX_B or len(EV) != B or len(wis) != B:
        raise ValueError(f'score kernels: {B} backgrounds, 1 to {MAX_B} '
                         'with a plane pair and a radius each')
    for t in (*SV, *EV):
        if (t.dtype != torch.float32 or t.shape != sh.raw.shape
                or not t.is_contiguous() or t.device != sh.raw.device):
            raise TypeError('score kernels: contiguous float32 planes of the '
                            'band\'s shape on its device required')
    ptrs = ctypes.c_void_p * B
    return (ptrs(*(t.data_ptr() for t in SV)),
            ptrs(*(t.data_ptr() for t in EV)),
            (ctypes.c_int * B)(*(int(w) for w in wis)))


@functools.lru_cache(maxsize=8)
def edge_table(device):
    """float32 [2, :data:`N_EDGES`]: each chunk id's left and right edge,
    computed on ``device`` by :func:`score.chunk_edges`, the ops
    ``lambda_chunks`` runs, so the kernels compare against its bits."""
    c = torch.arange(N_EDGES, dtype=torch.int32, device=device)
    return torch.stack(score_ops.chunk_edges(c, torch.float32)).contiguous()


@functools.lru_cache(maxsize=8)
def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def score_observe(sh, SV, EV, wis, margin, S, C, lib=None):
    """int32 [num_p * Lp] counts ``clamp(floor(O), 0, C - 1)``, int32 [B,
    num_p * Lp] chunk ids (``clamp(cid, 1, S - 1)`` where valid, else 0:
    ``score.chunk_pack``'s) and uint8 [B, num_p * Lp] flags (scored,
    valid, and ``score.lambda_suspects`` at ``margin``).

    ``sh``: the chromosome's sheets (``engine.Sheets``); ``SV``, ``EV``:
    each background's capture planes [num_p, Lp]; ``wis``: each
    background's window radius (ints).  CPU tensors take the twin; CUDA
    tensors launch the kernel or raise."""
    if sh.raw.device.type == 'cpu':
        return score_observe_twin(sh, SV, EV, wis, margin, S, C)
    from ..kernels.build import check
    lib = lib or _library()
    sheets, num_p, Lp = _common(sh)
    sv, ev, wi = _planes(sh, SV, EV, wis)
    B, dev = len(SV), sh.raw.device
    oc = torch.empty(num_p * Lp, dtype=torch.int32, device=dev)
    cid0 = torch.empty((B, num_p * Lp), dtype=torch.int32, device=dev)
    flags = torch.empty((B, num_p * Lp), dtype=torch.uint8, device=dev)
    edges = edge_table(dev)
    with torch.cuda.device(dev):
        err = lib.lib.hp_score_observe(
            *sheets, num_p, Lp, int(sh.L), ctypes.addressof(sv),
            ctypes.addressof(ev), ctypes.addressof(wi), B, edges.data_ptr(),
            _LN2, margin, S, C, oc.data_ptr(), cid0.data_ptr(),
            flags.data_ptr(), _sms(dev),
            torch.cuda.current_stream().cuda_stream)
    check(err, 'score observe')
    score_observe.launches += 1
    return oc, cid0, flags


score_observe.launches = 0


def score_keep(raw, gap_drop, cid0, flags, thr2, sig, C, exact, lib=None):
    """bool [B, num_p, Lp] keep mask: ``score.chunk_keep`` at the
    thresholds ``thr2`` [B, S] of the summed histogram, outside the gap
    filter, and in ``exact`` mode outside the suspects; and the suspects'
    mask (None outside ``exact`` mode).  ``cid0`` and ``flags``:
    :func:`score_observe`'s.  CPU tensors take the twin; CUDA tensors launch
    the kernel or raise."""
    if raw.device.type == 'cpu':
        return score_keep_twin(raw, gap_drop, cid0, flags, thr2, sig, C,
                               exact)
    from ..kernels.build import check
    lib = lib or _library()
    B, S = thr2.shape
    num_p, Lp = raw.shape
    thr2 = thr2.contiguous()
    if (thr2.dtype != torch.float32 or raw.dtype != torch.float32
            or cid0.shape != (B, num_p * Lp) or flags.shape != cid0.shape
            or gap_drop.shape != raw.shape
            or any(t.device != raw.device or not t.is_contiguous()
                   for t in (raw, gap_drop, cid0, flags, thr2))):
        raise TypeError('score keep: float32 band and thresholds and '
                        'observe\'s chunk ids and flags, contiguous on one '
                        'device, required')
    dev = raw.device
    kept = torch.empty((B, num_p, Lp), dtype=torch.bool, device=dev)
    sus = torch.empty_like(kept) if exact else None
    sig1 = bool(np.float32(sig) >= 1.0)
    with torch.cuda.device(dev):
        err = lib.lib.hp_score_keep(
            raw.data_ptr(), gap_drop.data_ptr(), cid0.data_ptr(),
            flags.data_ptr(), thr2.data_ptr(), num_p, Lp, B, S, C, int(sig1),
            int(exact), kept.data_ptr(), sus.data_ptr() if exact else None,
            _sms(dev), torch.cuda.current_stream().cuda_stream)
    check(err, 'score keep')
    score_keep.launches += 1
    return kept, sus


score_keep.launches = 0


def score_gather(sh, SV, EV, wis, kept, sus, C, prod=True, lib=None):
    """The values of a few pixels, from the planes: for ``kept`` = (d, x)
    int32 [B, K], each pixel's O, ICE and Fold (float32) and chunk where
    valid (int32, else 0); for ``sus`` = (d, x) [B, Ks], its chunk, count
    ``clamp(floor(O), 0, C - 1)`` (int32), gap flag (bool) and, with
    ``prod``, prod (float32).  Either set may be None.  Row b of a set
    reads background b.  CPU tensors take the twin; CUDA tensors launch
    the kernel (none where both sets are empty) or raise."""
    if sh.raw.device.type == 'cpu':
        return score_gather_twin(sh, SV, EV, wis, kept, sus, C, prod)
    from ..kernels.build import check
    lib = lib or _library()
    sheets, num_p, Lp = _common(sh)
    sv, ev, wi = _planes(sh, SV, EV, wis)
    B, dev = len(SV), sh.raw.device
    sets = []
    for pair in (kept, sus):
        if pair is None:
            sets.append((None, None, 0))
            continue
        d, x = (t.contiguous() for t in pair)
        if (d.dtype != torch.int32 or x.dtype != torch.int32
                or d.shape != x.shape or d.dim() != 2 or d.shape[0] != B
                or d.device != dev):
            raise TypeError('score gather: int32 [B, K] indices on the '
                            'band\'s device required')
        sets.append((d, x, d.shape[1]))

    def new(pair, K, dtypes):
        if pair is None:
            return (None,) * len(dtypes)
        return tuple(torch.empty((B, K), dtype=t, device=dev) for t in dtypes)
    (d0, x0, K0), (d1, x1, K1) = sets
    out0 = new(kept, K0, (torch.float32, torch.float32, torch.float32,
                          torch.int32))
    out1 = new(sus, K1, (torch.int32, torch.int32, torch.bool)
               + ((torch.float32,) if prod else ()))
    got = tuple(t for t in out0 + out1 if t is not None)
    if B * (K0 + K1) == 0:
        return got

    def ptrs(ts):
        return [None if t is None else t.data_ptr() for t in ts]
    out1 += (None,) * (4 - len(out1))
    with torch.cuda.device(dev):
        err = lib.lib.hp_score_gather(
            *sheets, sh.cband.data_ptr(), sh.gap_drop.data_ptr(), num_p, Lp,
            int(sh.L), ctypes.addressof(sv), ctypes.addressof(ev),
            ctypes.addressof(wi), B, edge_table(dev).data_ptr(), _LN2, C,
            *ptrs((d0, x0)), K0, *ptrs(out0), *ptrs((d1, x1)), K1,
            *ptrs(out1), _sms(dev), torch.cuda.current_stream().cuda_stream)
    check(err, 'score gather')
    score_gather.launches += 1
    return got


score_gather.launches = 0


def score_prod(sh, SV, EV, wis, C, b, d, x):
    """prod of background ``b`` at the (d, x) pixels (lists of ints), as
    numpy: :func:`score_gather`'s, one launch where there is a pixel.
    ``launches`` counts these launches (:func:`score_gather`'s count holds
    them too)."""
    dev = sh.raw.device
    di = torch.tensor(d, dtype=torch.int32, device=dev)[None]
    xi = torch.tensor(x, dtype=torch.int32, device=dev)[None]
    before = score_gather.launches
    got = score_gather(sh, [SV[b]], [EV[b]], [wis[b]], None, (di, xi), C)[3]
    score_prod.launches += score_gather.launches - before
    with span(SYNC):
        return got[0].cpu().numpy()


score_prod.launches = 0


class PlaneProd:
    """The postcheck's handle on each background's prod (``EM * ratio``,
    ``score.expected_observed``'s sixth sheet), kept as the sheets and
    capture planes it is computed from: :meth:`gather` computes the few
    pixels the postcheck reads, bit for bit the dense sheet's."""

    def __init__(self, sh, SV, EV, wis, C):
        self.sh, self.SV, self.EV, self.wis, self.C = sh, SV, EV, wis, C

    def gather(self, b, d, x):
        """prod of background ``b`` at the (d, x) pixels, as numpy."""
        return score_prod(self.sh, self.SV, self.EV, self.wis, self.C, b, d,
                          x)
