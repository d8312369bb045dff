"""The (chunk, count) histogram: CUDA kernel wrapper and its plain twin.

Replaces ``hicpeaks_tpu/ops/pallas_hist.py::chunk_hist_pallas``.  The
kernel is ``csrc/chunk_hist.cu``; for CPU tensors the wrapper runs the
plain twin, a ``torch.bincount`` over ``cid*C + count``.  Unlike the JAX
function the port does not pad its input, so its histogram differs from
JAX's only in the trash cell (0, 0), which no valid pixel reads.
"""
from __future__ import annotations

import torch


def chunk_hist_torch(oc, cid, S, C):
    """Plain twin: int32 [B*S, C] histogram of (chunk, count) pairs.

    ``oc``: int32 [n] counts (shared by the B backgrounds); ``cid``: int32
    [B, n] chunk ids, background b landing in rows ``b*S .. b*S+S-1``.
    A chunk id outside [0, S) or a count outside [0, C) counts nowhere."""
    B, _ = cid.shape
    b_off = torch.arange(B, device=cid.device, dtype=torch.int64)[:, None] * S
    ok = (cid >= 0) & (cid < S) & (oc >= 0) & (oc < C)
    key = (cid.to(torch.int64) + b_off) * C + oc.to(torch.int64)
    return torch.bincount(key[ok], minlength=B * S * C) \
        .reshape(B * S, C).to(torch.int32)


def chunk_hist(oc, cid, S, C, lib=None):
    """int32 [B*S, C] histogram of (chunk id, count) over ``B``
    backgrounds in one launch (see :func:`chunk_hist_torch` for the
    layout).  CPU tensors take the plain twin; CUDA tensors launch the
    kernel or raise.  ``lib``: the kernel library to launch from (a
    :class:`~hicpeaks_tpu_torch.kernels.build.KernelLibrary`; default the
    package's own build)."""
    if oc.device.type == 'cpu' and cid.device.type == 'cpu':
        return chunk_hist_torch(oc, cid, S, C)
    if oc.device.type != 'cuda' or cid.device != oc.device:
        raise ValueError(f'chunk_hist: tensors on {oc.device} and '
                         f'{cid.device}; both must be on one CUDA device '
                         '(or both on the CPU)')
    if oc.dtype != torch.int32 or cid.dtype != torch.int32:
        raise TypeError(f'chunk_hist: int32 inputs required, got '
                        f'{oc.dtype}/{cid.dtype}')
    if oc.dim() != 1 or cid.dim() != 2 or cid.shape[1] != oc.shape[0]:
        raise ValueError(f'chunk_hist: shapes {tuple(oc.shape)} and '
                         f'{tuple(cid.shape)}; want [n] and [B, n]')
    if not (oc.is_contiguous() and cid.is_contiguous()):
        raise ValueError('chunk_hist: inputs must be contiguous')
    if S < 1 or C < 1:
        raise ValueError(f'chunk_hist: S={S}, C={C}')
    from ..kernels.build import check, load
    lib = lib or load()
    B, n = cid.shape
    hist = torch.zeros((B * S, C), dtype=torch.int32, device=oc.device)
    if n == 0:
        return hist
    with torch.cuda.device(oc.device):
        sms = torch.cuda.get_device_properties(oc.device) \
            .multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lib.hp_chunk_hist(oc.data_ptr(), cid.data_ptr(), n, B, S,
                                    C, hist.data_ptr(), sms, stream)
    check(err, 'chunk_hist')
    chunk_hist.launches += 1
    return hist


chunk_hist.launches = 0
