"""Multi-process orchestration on ``torch.distributed``.

Port of ``hicpeaks_tpu/parallel/multihost.py``.  Two strategies, as in
JAX:

* **chromosome data-parallelism**: chromosomes are partitioned
  round-robin over the processes (:func:`assign_chroms`, the same
  assignment on every process with no communication); each process calls
  its chromosomes on its own device, optionally tile-sharded over a local
  mesh (:func:`local_tile_mesh`), and the small peak tables are
  all-gathered (:func:`gather_tables`) so every process returns the whole
  genome's table;
* **a global mesh** (:func:`global_tile_mesh`): every process works
  every chromosome together, each on the column tiles it owns.  Each
  process reads only its tiles' pixel rows from the cooler and the
  O(num + L) partial sums are reduced with one all-gather
  (:func:`sharded_bands_from_cooler`); the engine exchanges halos and
  counts across processes (``parallel/tiles``).

Host data moves on the default gloo group (``parallel/launch``).
"""
from __future__ import annotations

import json
import logging

import numpy as np
import torch
import torch.distributed as dist

from .launch import process_device, world
from .mesh import TileMesh

log = logging.getLogger(__name__)


def assign_chroms(labels, num_processes, process_id):
    """Deterministic round-robin partition of chromosome labels, in the
    caller's (cooler) order; every process computes the same assignment."""
    return [c for i, c in enumerate(labels)
            if i % num_processes == process_id]


def _encode_tables(tables: dict) -> bytes:
    payload = {
        chrom: {','.join(map(str, k)): list(map(float, v))
                for k, v in table.items()}
        for chrom, table in tables.items()
    }
    return json.dumps(payload).encode()


def _decode_tables(blob: bytes) -> dict:
    payload = json.loads(blob.decode())
    return {chrom: {tuple(int(float(x)) for x in k.split(',')): tuple(v)
                    for k, v in table.items()}
            for chrom, table in payload.items()}


def gather_tables(local_tables: dict, cap_bytes: int = 1 << 24) -> dict:
    """All-gather per-process peak tables to every process: one fixed-size
    uint8 buffer per process (an 8-byte length, then the JSON encoding),
    gathered over the gloo group; an encoding above ``cap_bytes`` raises.
    A single process returns its tables unchanged."""
    nproc, _ = world()
    if nproc == 1:
        return dict(local_tables)
    blob = _encode_tables(local_tables)
    if len(blob) > cap_bytes:
        raise ValueError(f'peak tables exceed gather cap: {len(blob)} bytes')
    buf = np.zeros(cap_bytes + 8, np.uint8)
    buf[:8] = np.frombuffer(np.int64(len(blob)).tobytes(), np.uint8)
    buf[8:8 + len(blob)] = np.frombuffer(blob, np.uint8)
    rows = [torch.empty(cap_bytes + 8, dtype=torch.uint8)
            for _ in range(nproc)]
    dist.all_gather(rows, torch.from_numpy(buf))
    merged = {}
    for row in rows:
        row = row.numpy()
        n = int(np.frombuffer(row[:8].tobytes(), np.int64)[0])
        merged.update(_decode_tables(row[8:8 + n].tobytes()))
    return merged


def local_tile_mesh(n_tiles=None, device=None):
    """A tile mesh on this process's own device only (``device``, default
    :func:`parallel.launch.process_device`), ``n_tiles`` tiles (default
    1), so halos never cross processes."""
    device = process_device() if device is None else torch.device(device)
    return TileMesh([device] * (n_tiles or 1))


def global_tile_mesh(devices=None):
    """A 1-D tile mesh over every process of the group: each process
    contributes the tiles of ``devices`` (default one tile on its own
    device), in rank order."""
    nproc, rank = world()
    mine = [str(torch.device(d)) for d in (devices or [process_device()])]
    every = [mine]
    if nproc > 1:
        every = [None] * nproc
        dist.all_gather_object(every, mine)
    devs, owners = [], []
    for r, ds in enumerate(every):
        devs += ds
        owners += [r] * len(ds)
    return TileMesh(devs, owners, rank)


def _host_sum_int(x):
    """Exact sum of an integer host array across the processes (gloo), so
    the float64 ring sums of per-process column spans are the
    single-process ones bit for bit."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.int64))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).sum(dim=0).numpy()


def sharded_bands_from_cooler(clr, chrom, maxapart, maxww, ww_min, mesh,
                              dtype=np.float64, weight_name='weight',
                              lane_pad=128, sublane_pad=8):
    """Per-process band ingestion for a tile-sharded chromosome (JAX
    ``multihost.py:94-232``).

    Each process reads only the pixel rows of the column tiles it owns
    (``io/coolerlite.pixels_for_bin1_range``: the ``bin1_offset`` index
    makes a column span one contiguous slice) and keeps them as host slabs
    (``bands.raw_spans``, {(c0, c1): [num_p, c1 - c0]}); ``bands.raw`` is
    None.  The O(num + L) partials (the 128-column blocked balanced sums,
    the NaN counts, the column sums, the candidate histogram and the max
    count) are reduced across processes with one all-gather, so IR, the
    gap vector and the candidate totals are the whole chromosome's.  The
    padded width ``Lpm`` is a multiple of ``n_tiles * CSUM_BLOCK``: a
    tile never splits a csum block, the partials merge by placement, and
    IR is bit-identical to the single-process loader's at any process
    count.  The vectors are ``Lpm`` long.  The slabs and vectors are
    ``dtype``, float64 by default as in JAX."""
    from ..ops.band import (CSUM_BLOCK, ChromBands, _round_up, blocked_csum,
                            fold_blocked_csum)
    res = clr.binsize
    lo, hi = clr.bin_range(chrom)
    L = hi - lo
    num = maxapart // res + maxww + 1
    Lp = _round_up(max(L, 1), lane_pad)
    num_p = _round_up(max(num, 1), sublane_pad)
    n_tiles = mesh.size
    Lpm = _round_up(Lp, n_tiles * CSUM_BLOCK)
    T = Lpm // n_tiles
    w = np.asarray(clr.weights(chrom, weight_name), np.float64)

    spans = {}
    b1_parts, dd_parts, ct_parts = [], [], []
    for i in mesh.local_tiles:
        c0, c1 = i * T, (i + 1) * T
        b1s, b2s, cts = clr.pixels_for_bin1_range(chrom, c0, min(c1, L))
        ds = (b2s - b1s).astype(np.int64)
        sel = (ds >= 0) & (ds < num) & (b2s < L)
        b1s, ds, cts = b1s[sel], ds[sel], cts[sel].astype(np.float64)
        slab = np.zeros((num_p, T), dtype)
        slab[ds, b1s - c0] = cts
        spans[(c0, c1)] = slab
        b1_parts.append(b1s)
        dd_parts.append(ds)
        ct_parts.append(cts)
    b1 = np.concatenate(b1_parts)
    dd = np.concatenate(dd_parts)
    ct = np.concatenate(ct_parts)

    # every partial merges exactly: csum as per-128-column-block partials
    # (each block owned by one process), colsum per column (one owner),
    # nan and cand as integers
    wprod = w[b1] * w[b1 + dd]
    nanmask = np.isnan(wprod)
    cvals = np.where(nanmask, 0.0, ct * wprod)
    csum_blk = blocked_csum(dd, b1, cvals, num_p, Lpm)
    nan_counts = np.bincount(dd[nanmask], minlength=num_p)[:num_p]
    in_rows = dd >= ww_min
    colsum = np.bincount(b1[in_rows], weights=cvals[in_rows],
                         minlength=Lpm)[:Lpm]
    cand = np.bincount(dd[ct != 0], minlength=num_p)[:num_p]
    max_count = float(ct.max()) if ct.size else 0.0
    if mesh.spans_processes:
        nb = csum_blk.shape[1]
        packed = torch.from_numpy(np.concatenate([
            csum_blk.ravel(), nan_counts.astype(np.float64), colsum,
            cand.astype(np.float64), [max_count]]))
        rows = [torch.empty_like(packed)
                for _ in range(dist.get_world_size())]
        dist.all_gather(rows, packed)
        rows = torch.stack(rows).numpy()
        total = rows.sum(axis=0)
        csum_blk = total[:num_p * nb].reshape(num_p, nb)
        nan_counts = total[num_p * nb:num_p * nb + num_p]
        colsum = total[num_p * nb + num_p:num_p * nb + num_p + Lpm]
        cand = total[num_p * nb + num_p + Lpm:-1]
        max_count = float(rows[:, -1].max())
    csum = fold_blocked_csum(csum_blk)

    diag_len = np.maximum(L - np.arange(num_p), 0)
    denom = diag_len - nan_counts
    with np.errstate(invalid='ignore', divide='ignore'):
        IR = csum / denom
    IR[:ww_min] = 0.0
    IR[num:] = 0.0
    gap = colsum == 0

    valid = ~((w == 0) | np.isnan(w))
    bias = np.zeros(Lpm, np.float64)
    bias[:L][valid] = 1.0 / w[valid]
    w0 = np.zeros(Lpm, np.float64)
    w0[:L][valid] = w[valid]
    nanw = np.zeros(Lpm, bool)
    nanw[:L] = np.isnan(w)

    bands = ChromBands(raw=None, IR=IR.astype(dtype), bias=bias.astype(dtype),
                       w0=w0.astype(dtype), gap=gap, L=L, num=num, res=res,
                       chrom=chrom.lstrip('chr'), ww_min=ww_min,
                       sparse=(dd, b1, cvals, ct), nanw=nanw,
                       cand_hist=cand.astype(np.int64), max_count=max_count,
                       IR64=IR, bias64=bias, w064=w0)
    bands.raw_spans = spans       # this process's tiles, for the engine and
                                  # the float64 host-exact statistics
    bands.raw_shape = (num_p, Lpm)
    bands.span_sum = _host_sum_int if mesh.spans_processes else None
    return bands
