"""Float64 completion of pyHICCUPS's compacted pixels on the device that
holds the band.

The fused pyHICCUPS scorer (``engine._compact_batched``) leaves on the
device its ``ops.score.Compacted`` record: for each background, the
compacted superset of its significant pixels, the lambda-chunk edge
suspects with their device (chunk, count) cells and keep thresholds, and
the integer (chunk, count) histogram.
:func:`complete_on_device` finishes them there, as
``hostcomplete._compact_to_host`` does on the host, with the same numbers:

* every pixel's float64 O, E, Fold, ICE and (chunk, count) cell, from the
  band (``ops/cuda_complete.window_stats64``: a kernel on a card, the host
  code on the CPU);
* each suspect moved from its device cell to its float64 one in the
  histogram (integer moves, exact in any order), the BH tables from it and
  the (S, C) p table that :func:`hostcomplete.ptab64` keeps, in
  ``host_chunk_qtab64``'s order, p and q by (chunk, count) lookup, the
  kept pixels' ``q <= sig``, the suspects' ``q <= sig`` outside the gap
  filter, and the audit that sends a background to the dense scorer
  (``ops/cuda_complete.finish64``: a second kernel on a card, the host
  completion's own table steps on the CPU);
* the finished rows in the host's order (kept pixels, then suspects, each
  row-major), brought back in two blocking reads: the counts with the
  audit's, then the rows.

The engine takes this route for the batched scorer on one device
whenever float64 completion applies, on a card and on the CPU alike; the
host route stays for pyBHFDR, the dense scorer, checkify and the tiles.
Under a capture it is one ``hicpeaks.complete64`` span.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import cuda_complete
from .hostcomplete import log_failed_audit, ptab64
from .spans import SYNC, span

_ROW = ('x', 'y', 'O', 'ICE', 'Fold', 'p', 'q')


@functools.lru_cache(maxsize=4)
def _ptab_on(S, C, device):
    return torch.tensor(ptab64(S, C), dtype=torch.float64, device=device)


def _read(t):
    with span(SYNC):
        return t.cpu().numpy()


def complete_on_device(sh, out, bgs, ctx, sig):
    """The batched scorer's ``ops.score.Compacted`` ``out`` (exact mode)
    -> one host dict a background, as ``hostcomplete._compact_to_host``
    returns it, or None where the suspect audit fails.  ``bgs``: (p, w,
    kind, capture) a background."""
    with span('hicpeaks.complete64'):
        B, S, C = out.hist.shape
        stats, cell = cuda_complete.window_stats64(
            sh.raw, ctx, [(p, kind) for p, _, kind, _ in bgs], out)
        rows, fin, head = cuda_complete.finish64(
            out, cell, stats, _ptab_on(S, C, out.hist.device), sig)
        # the kept rows in order, background by background
        T = fin.shape[0]
        dest = torch.where(fin, torch.cumsum(fin, 0) - 1,
                           T + torch.arange(T, device=fin.device))
        packed = torch.empty((2 * T, 7), dtype=torch.float64,
                             device=fin.device).index_copy_(0, dest, rows)
        n_fin, n_missed = _read(head)
        total = int(n_fin.sum())
        got = _read(packed[:total]) if total else np.zeros((0, 7))

        res, s = [], 0
        for b in range(B):
            r, s = got[s:s + n_fin[b]].T, s + n_fin[b]
            if n_missed[b]:
                res.append(log_failed_audit(int(n_missed[b])))
                continue
            row = {k: np.ascontiguousarray(v) for k, v in zip(_ROW, r)}
            row['x'] = row['x'].astype(np.int32)
            row['y'] = row['y'].astype(np.int32)
            res.append(dict(row, prod=(out.prod, b)))
        return res
