#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hicpeaks_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
imports neither JAX nor h5py (coolers go through the port's io/h5lite).
It exits non-zero on any failure, and without a CUDA card.  Phases:

1. the card (nvidia-smi) and the kernels' build from csrc/;
2. each CUDA kernel against its plain PyTorch twin at the bench shape
   (bench.py: L=8192 bins at 10 kb, 2 Mb span, pw=2, ww=5, maxww=10,
   seed 0): pass-A counts equal, pass-B captures bit-equal, histogram
   equal; times by CUDA events (median of repeats: one call a sample, and
   where that reads under 2 ms also 20 back-to-back calls a sample,
   which is then the time), each beside its bound (the least time for its
   bytes and operations at the H100's peaks) and, for the histogram,
   beside one ``torch.bincount`` of the same inputs;
   then the scan kernels again on the multi-pair plan pw=(1, 2),
   ww=(3, 5), maxww=10, whose drift re-adds read kept rings;
3. the main path, ``hiccups_chrom`` on the card, with every kernel's
   launch count, and its table against the float64 oracle
   (tests/oracle/reference_impl.py): identical loci and geometry, max
   relative stat difference < 1e-8; then JAX's call form,
   ``hiccups_chrom(bands, cfg)`` with no ``device``, which must launch
   the same kernels as often and return the same table (the default
   device is the card); the float64 completion's two kernels
   (``window_stats64``, ``finish64``) on the inputs of one more such call,
   each bit-equal to its twin (the host completion), timed beside its
   bound, and so the batched scorer's fused kernels (``score_observe``,
   ``score_keep``, ``score_gather``) against their twin, the eager chain;
4. chr1 scale at the CLI default span (L=24,900 at 10 kb, 10 Mb): the
   main path's kernel launches in its first call and the steady
   per-chromosome wall of the second, and the kernel checks of phases 2
   and 3 on that chromosome's sheets and main-path inputs, the scorer's
   kernels also at the upstream QuickStart's three pairs (B = 6);
5. pyBHFDR at the bench shape and the pyBHFDR CLI defaults (pw=2, ww=5,
   maxww=10, 2 Mb): the scan kernels against their twins on the pyBHFDR
   plan and gate, the global-BH iteration count, ``bhfdr_chrom`` on the
   card with its kernel launch counts, and its table against the float64
   oracle (identical loci and geometry, max relative stat difference
   < 1e-8, identical sorted 13-column bedpe lines);
6. pyBHFDR at chr1 scale (L=24,900 at 10 kb, 2 Mb): the kernel launches
   of the first ``bhfdr_chrom`` call and the steady wall of the second,
   and the scan-kernel checks of phase 5 on that chromosome's sheets;
7. deep data: the histogram against its twin and ``torch.bincount``
   (median of 20) at three count caps, B = 2 on the chr1 band: (a) phase
   4's inputs (o_cap 1024, S = 40), (b) the chr1 synthesis at depth
   DEEP_DEPTH (o_cap 16384, S = 48), (c) (b)'s ids with log-uniform counts
   over [0, 131072] (S = 56), printed as one ``chunk_hist_shapes`` JSON
   line; the kernel checks of phase 2 on (b)'s sheets; then
   ``hiccups_chrom`` on the bench-shape chromosome at that depth (o_cap
   >= 2048 asserted) with its launch counts, against the float64 oracle;
8. the fallback ladder on the card, each route with its kernel launches:
   (a) both callers at the bench shape with ``scan_backend='validate'``
   (each scan kernel against its twin inside the call, on the host-gate
   route) and (b) with ``bh_backend='host'`` (the dense scorer), against
   phases 3 and 5's oracle tables; (c) the bench shape with one candidate
   pixel at 150,000 counts, above the histogram's cap: ``hiccups_chrom``
   under 'auto' (device segmented BH) and 'host' against one oracle on that
   data; (d) ``check=True`` for both callers against the unchecked tables,
   and a NaN-poisoned copy that must raise; (e) the dense scorer on phase
   4's chr1 band, loci against the fused route's, with its walls; (f) the
   crossing: pyBHFDR at its CLI defaults on chr1 at 1 kb (L=248,956, 2 Mb
   span), built diagonal by diagonal deep enough that 10 * total >= 2^31,
   through the host-gate route, with the scan kernels against their twins
   on its sheets (pass B's full-width launch against the twin in column
   strips), peak device memory, walls and the walls of its stages;
9. the user pipeline, every cooler through io/h5lite, under build/smoke/
   (removed afterwards): (a) chr21 and chr22 (hg38) at 25 kb, full intra
   span, as TXT (1 % of lines mirrored, plus 20,000 trans pixels), through
   ``python -m hicpeaks_tpu_torch.cli.tocooler --device cuda``, intra-only
   and ``--includeTrans``: pixels equal to the symmetrized input, weights
   within 1e-9 of the port's ICE on the CPU with the same NaN mask,
   ``n_iters`` and ``converged``, and a second balance on the card
   bit-identical; (b) phase 4's chr1 as a cooler, balanced on the card
   (two calls), then both CLIs on it with ``--device cuda``, each bedpe
   byte-identical to the in-process engine's on the cooler's bands (read
   wall, ICE walls, CLI walls); (c) chromosomes 1-22 and X at hg38
   lengths, 10 kb, pixels within 2 Mb (depth 40), written, balanced on the
   card and called by ``call_bhfdr`` on the card: walls by stage and by
   chromosome, peak device memory, peaks; printed as one
   ``user_pipeline`` JSON line;
10. the figures' path, on phase 9's files before they are removed: (a)
   APA of (c)'s calls on (c)'s cooler, ``cli.apa.apa_stats`` on the card
   and on the CPU with every output bit-identical (walls by stage, peak
   device memory), then the apa-analysis CLI on the card in a process of
   its own printing the same count; (b) one chr21 library (hg38 length,
   5 kb fine bins, seed 21) binned at 5, 10 and 25 kb, balanced on the
   card, the pyHICCUPS CLI on the card at each (HiCCUPS's pw/ww for the
   resolution), each bedpe byte-identical to the in-process engine's on
   the cooler's bands, which is held against the float64 oracle at 10 and
   25 kb, then the combine-resolutions CLI, its file equal to
   ``combine_annotations`` and at least one fine peak confirmed by a
   coarser one; (c) where matplotlib is installed, the APA figure drawn
   from the CPU byte-identical to the card's, and peak-plot of 4 Mb of
   chr21 at 10 kb with the combined loops; printed as one ``figures`` JSON
   line;
11. the multi-device layer on the one card (``parallel/``): (a) a mesh of
   4 tiles, all on the card, in one process (run after phase 8): both
   callers at the bench shape against phases 3 and 5's oracle tables;
   on phase 4's and 6's chr1, the tiles' summed pass-A counts equal to
   one device's, their stitched pass-B captures bit-equal and (pyHICCUPS)
   their summed histogram equal in rows >= 1; the kernel launches of
   each mesh call (4 of each scan, 4 or 0 histograms), the steady walls
   of the mesh and one-device calls, the pyBHFDR mesh table == one
   device's, the pyHICCUPS one with identical loci and geometry and its
   stats within 1e-8 (the tiles set the lambda-chunk edge suspects aside
   as one device does; JAX's mesh route does not), their count; (b)
   ``ir_backend='device'`` on the chr1 pyHICCUPS mesh: loci and geometry
   identical to the host IR's table.  Then, on phase 9's files before they
   are removed: (c) two processes sharing the card on gloo
   (``HICPEAKS_*``): ``call_bhfdr`` on 9c's genome, each process's table
   == 9c's, and the pyBHFDR CLI in two processes, both bedpe files
   byte-identical to 9c's; (d) a global mesh of 2 processes x 2 tiles on
   9b's chr1 cooler: each process reads only its tiles' columns, IR
   bit-equal to ``bands_from_cooler``'s, both callers' tables held to
   (a)'s bars against one device's on the cooler's bands; one ``multi``
   JSON line.  The tiles take turns on one card: the walls are the cost
   of tiling, not a speed-up;
12. the trace (``profile_dir``), on 9b's chr1 cooler before it is
   removed: ``api.call_hiccups`` (10 Mb) and ``api.call_bhfdr`` (2 Mb) on
   chromosome 1, once to warm up in JAX's call form (no ``device``) and
   once with ``device='cuda'`` and ``profile_dir``; each
   trace holds CUDA kernels, and ``scan_pass_a_kernel``,
   ``scan_pass_b_kernel`` and ``chunk_hist_kernel`` as many times as
   their launch counters give, which are the fused route's 1 / 1 / 1
   (pyHICCUPS) and 1 / 1 / 0 (pyBHFDR); the traced table == the
   JAX-form one; printed: the traced window, the device's busy time (the
   union of its kernels, copies and memsets) and idle share, the five
   kernels with the most device time, each hand-written kernel's traced
   time beside its CUDA-event time from phases 4 and 6, and the card's
   nvidia-smi line; one ``trace`` JSON line;
13. the prefetch thread's staging, on 9c's genome cooler before it is
   removed: ``api.call_hiccups`` on chromosomes 1-3 and ``api.call_bhfdr``
   on all 23, on the card with ``profile_dir``; every chromosome called
   staged once (``engine.stage_chrom_arrays.staged``), the kernels
   launched once a chromosome as the fused route does, each table == the
   engine's on ``bands_from_cooler``'s unstaged bands, pyBHFDR's also ==
   9c's; in the trace, each chromosome's slab after the first copied as
   ``Memcpy HtoD (Pinned -> Device)`` on a stream none of its kernels runs
   on, and no slab as a pageable copy.  Printed per chromosome: the
   copy's traced ms and bytes, how long it overlapped the previous
   chromosome's kernels, and the consumer's wait from its call's start
   (the ``Chrom:<label>`` mark) to its first kernel; each call's peak
   device memory; one ``staging`` JSON line;
14. the fused scorer's kernels' launches a chromosome call on every route,
   from the kernel records: once on the batched pyHICCUPS scorer on one
   device (bench, chr1, deep data, ``validate``, the CLI's bands, ``api``
   traced and staged, the three resolutions of 10b), ``score_gather``
   once more a pair whose postcheck has a pixel (``score_prod`` counts
   those), never on pyBHFDR, the dense and segmented scorers,
   ``check=True``, the tiles or APA.

    python3 chip_smoke.py --crossing-only

runs phases 1 and 8f alone, in a process that holds nothing else, and
prints no result line; ``--pipeline-only`` does the same for phases 9 and
10, ``--multi-only`` for phases 1 and 11 (with phases 9b and 9c first,
for their coolers), and ``--trace-only`` for phases 1, 12 and 13 (12 on
a chr1 cooler written and balanced as 9b's, 13 on 9c's genome cut to
chromosomes 1-3).

Before the result lines, one ``defaults:`` line gives phases 3 and 12's
JAX-form calls (no ``device``): their peaks, launches and equality with
the ``device='cuda'`` tables.  The line before the last is one JSON
object with a record per kernel (its
main keys from phase 4, the others prefixed by phase or histogram shape,
phase 11's by ``mesh4.`` and ``global2x2.``);
the last line is {"ok": true, "device": {...}}.
"""
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RES = 10000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12       # outside the tensor cores
PW, WW, MAXWW = (2,), (5,), 10
# phase 7's synthesis depth: chr1 (seed 42) then plans o_cap 16384
DEEP_DEPTH = 640.0
# phase 8's bar for the dense and segmented routes: they emit the device's
# float32 O, ICE and Fold (E's float32 ring sums bound its relative error
# by (3 * 441 + 8) * 2^-24 ~ 8e-5 at maxww 10), a lambda-chunk flip moves
# one chunk's m by one, and segmented BH's p and q are float32 igamma values
# (within 3.7e-4 of float64 at counts 0-400).  Where the oracle's p is
# below P_FLOOR, its 1 - cdf is float64 cancellation noise (multiples of
# 2^-52, which q = p * m / rank carries up): there both tables must hold
# p < 10 * P_FLOOR, and that p and its q are not compared
DEVICE_RTOL, P_FLOOR = 1e-3, 1e-12
# phase 8f: chr1 at 1 kb, synthesized at this depth (bins 2 Mb apart
# still hold ~1 read), so that 10 * total crosses 2^31
CROSSING_L, CROSSING_RES, CROSSING_DEPTH = 248_956, 1000, 300.0
STRIP = 65536   # phase 8f's pass-B twin runs on strips this many columns wide
# a time below BATCH_BELOW_MS ms is taken over BATCH back-to-back calls
BATCH_BELOW_MS, BATCH = 2.0, 20
HAS_MATPLOTLIB = importlib.util.find_spec('matplotlib') is not None
KERNELS = (
    ('scan_pass_a', 'hicpeaks_tpu_torch/csrc/scan_pass_a.cu',
     'hicpeaks_tpu/ops/pallas_scan.py:141'),
    ('scan_pass_b', 'hicpeaks_tpu_torch/csrc/scan_pass_b.cu',
     'hicpeaks_tpu/ops/pallas_scan.py:222'),
    ('chunk_hist', 'hicpeaks_tpu_torch/csrc/chunk_hist.cu',
     'hicpeaks_tpu/ops/pallas_hist.py:46'),
    # the float64 completion of the fused pyHICCUPS scorer, which JAX runs
    # on the host (ops/hostexact.exact_stats, ops/score.host_chunk_qtab64)
    ('window_stats64', 'hicpeaks_tpu_torch/csrc/complete64.cu',
     'hicpeaks_tpu/ops/hostexact.py:250'),
    ('finish64', 'hicpeaks_tpu_torch/csrc/complete64.cu',
     'hicpeaks_tpu/ops/score.py:906'),
    # the batched pyHICCUPS scorer's dense float32 stages, which JAX leaves
    # to XLA's fusion (ops/score.py expected_observed, lambda_chunks,
    # chunk_bh_keep_batched, lambda_suspects)
    ('score_observe', 'hicpeaks_tpu_torch/csrc/score_fused.cu',
     'hicpeaks_tpu/ops/score.py:141'),
    ('score_keep', 'hicpeaks_tpu_torch/csrc/score_fused.cu',
     'hicpeaks_tpu/ops/score.py:585'),
    # the compacted pixels' values, where JAX gathers its dense sheets
    ('score_gather', 'hicpeaks_tpu_torch/csrc/score_fused.cu',
     'hicpeaks_tpu/core/engine.py:440'),
)
# launch counters that are not kernels of their own: ``score_prod``
# counts the postcheck's launches of score_gather (one a pair whose
# postcheck has a pixel), which score_gather's count holds too
COUNTED = (('score_prod', 'hicpeaks_tpu_torch/csrc/score_fused.cu',
            'hicpeaks_tpu/core/engine.py:440'),)
# counters a route may leave at 0 where it launches every kernel: the
# postcheck's gathers, 0 where no pair's postcheck has a pixel
POSTCHECK_ONLY = ('score_prod',)


def log(msg):
    print(msg, flush=True)


def synth_bands(L, maxapart, seed, n_loops, span, lane_pad, depth=40.0,
                boost=None):
    """A synthetic chromosome's host bands, built in memory as bench.py and
    benchmarks/genome_scale.py build theirs.  ``boost`` = (d, count): the
    middle stored pixel of diagonal d gets that count."""
    import numpy as np
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops.band import build_bands
    num = maxapart // RES + MAXWW + 1
    b1, b2, ct, _, bias_vec = synthesize_chrom(
        n_bins=L, res=RES, seed=seed, depth=depth, n_loops=n_loops,
        decay=0.75, max_loop_span_bins=span)
    if boost is not None:
        on_d = np.nonzero(b2 - b1 == boost[0])[0]
        ct = ct.copy()
        ct[on_d[len(on_d) // 2]] = boost[1]
    w = np.full(L, np.nan)
    ok = bias_vec > 0
    w[ok] = 1.0 / bias_vec[ok]
    bands = build_bands(b1, b2, ct, w, L, num, min(WW), RES,
                        dtype=np.float32, lane_pad=lane_pad)
    return bands, w, bias_vec


def cuda_samples(fn, reps):
    """``reps`` samples of the milliseconds of one call of ``fn`` by CUDA
    events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` by CUDA events (:func:`cuda_samples`)."""
    return statistics.median(cuda_samples(fn, reps))


def cuda_batched_ms(fn, reps, k=BATCH):
    """Median over ``reps`` samples of the milliseconds of ``k``
    back-to-back calls of ``fn`` between two CUDA events, divided by
    ``k``, after one warm-up: the host's enqueue of one call overlaps the
    device work of the one before."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(k):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    return statistics.median(times)


def kernel_time(fn, reps):
    """{ms, single_ms, batched_ms} of ``fn``: ``single_ms`` one call a
    sample (:func:`cuda_ms`, the script's earlier method); below
    BATCH_BELOW_MS, where one call's time counts the host's enqueue, also
    ``batched_ms`` (:func:`cuda_batched_ms`), which is then ``ms``."""
    single = cuda_ms(fn, reps)
    if single >= BATCH_BELOW_MS:
        return dict(ms=single, single_ms=single, batched_ms=None)
    batched = cuda_batched_ms(fn, reps)
    return dict(ms=batched, single_ms=single, batched_ms=batched)


def bound_ms(bytes_, ops, ops_per_s=F32_OPS_PER_S):
    """The least time the card could take for ``bytes_`` moved once and
    ``ops`` float32 operations (float64 ones with ``ops_per_s`` =
    F64_OPS_PER_S): the larger of the two times at the H100 SXM's
    published peaks (3.35 TB/s HBM3, 67 TFLOP/s f32 and 34 TFLOP/s f64
    outside the tensor cores), and which one it is."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bytes=int(bytes_), ops=int(ops))


def timing(r):
    """How a record's ``ms`` was taken, for the log."""
    if r['batched_ms'] is None:
        return 'one call a sample'
    return (f'{BATCH} calls a sample; one call a sample '
            f'{r["single_ms"]:.4f} ms')


def max_abs(a, b):
    import torch
    if a.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))


def hist_check(oc, cid0, S, C, reps, kernel=None):
    """The histogram kernel (``kernel``, default the package's
    ``cuda_hist.chunk_hist``) against its twin and against one
    ``torch.bincount`` of the same inputs; raises on any disagreement and
    returns {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by,
    bytes, ops}."""
    import torch
    from hicpeaks_tpu_torch.ops import cuda_hist
    kernel = kernel or cuda_hist.chunk_hist
    h_k = kernel(oc, cid0, S, C)
    h_t = cuda_hist.chunk_hist_torch(oc, cid0, S, C)
    if not torch.equal(h_k, h_t):
        raise AssertionError(f'histogram differs by up to {max_abs(h_k, h_t)}')
    # the library yardstick: one torch.bincount over the flat (background,
    # chunk, count) index of the same inputs (every id and count is in
    # range, as the scorer's clamps leave them); the port never calls it
    B = cid0.shape[0]
    flat = ((torch.arange(B, device=oc.device)[:, None] * S
             + cid0.long()) * C + oc.long()[None, :]).reshape(-1)
    lib_h = torch.bincount(flat, minlength=B * S * C)
    if not torch.equal(lib_h.reshape(B * S, C).to(torch.int32), h_k):
        raise AssertionError('torch.bincount disagrees with the histogram')
    del lib_h
    return dict(
        max_abs_err=max_abs(h_k, h_t),
        **kernel_time(lambda: kernel(oc, cid0, S, C), reps),
        plain_ms=kernel_time(
            lambda: cuda_hist.chunk_hist_torch(oc, cid0, S, C), reps)['ms'],
        library_ms=kernel_time(
            lambda: torch.bincount(flat, minlength=B * S * C), reps)['ms'],
        # int32 counts and ids in, the int32 table out; one integer
        # increment per (background, pixel)
        **bound_ms(bytes_=oc.numel() * 4 + cid0.numel() * 4 + B * S * C * 4,
                   ops=cid0.numel()))


def kernel_checks(bands, cfg, device, reps, caller='hiccups', keep=None):
    """Each kernel of ``caller``'s path ('hiccups' or 'bhfdr') against its
    twin on the sheets, plan and freeze gate that path gives it.  Raises on
    any disagreement; returns {name: {max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by, bytes, ops}}.  A dict ``keep`` receives
    the histogram's inputs (oc, cid0, S, C) of the pyHICCUPS path."""
    import torch
    from hicpeaks_tpu_torch.core import engine, poolplan
    from hicpeaks_tpu_torch.ops import cuda_scan, score
    from hicpeaks_tpu_torch.ops import scan as twin

    res = bands.res
    if caller == 'hiccups':
        plan = tuple(poolplan.hiccups_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
        p_list = tuple(sorted(set(cfg.pw)))
        thr, d_lo = cfg.min_local_reads, min(cfg.ww)
    else:
        plan = tuple(poolplan.bhfdr_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
        p_list = (cfg.pw,)
        thr, d_lo = engine._BHFDR_THR, cfg.ww
    total = bands.candidate_total(d_lo, cfg.maxapart // res)
    ops = engine.bands_to_device(bands, device)
    raw, cband, eband, Bprod, gap_drop, cand = score.build_sheets(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        bands.ww_min, bands.L, d_lo, cfg.maxapart // res, d_lo)
    out = {}
    positions, n_cand = raw.numel(), int(cand.sum())
    maxw = cuda_scan.max_ring(plan)
    reads_adds = sum(len(e.reads_rings) for e in plan)
    bg_adds = sum(len(e.bg_rings) for e in plan)

    a_k = cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr)
    a_t = twin.scan_pass_a(raw, cand, plan, p_list, thr)
    if not torch.equal(a_k, a_t):
        raise AssertionError(f'pass A counts differ: kernel {a_k.tolist()} '
                             f'twin {a_t.tolist()}')
    out['scan_pass_a'] = dict(
        max_abs_err=max_abs(a_k, a_t),
        **kernel_time(
            lambda: cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr), reps),
        plain_ms=kernel_time(
            lambda: twin.scan_pass_a(raw, cand, plan, p_list, thr),
            reps)['ms'],
        library_ms=None,
        # f32 raw and bool mask in, int32 counts out; per position and
        # radius the Vn and Wq folds and the ring (3 adds), per candidate
        # the plan's Reads adds
        **bound_ms(bytes_=5 * positions + 4 * len(plan),
                   ops=3 * maxw * positions + reads_adds * n_cand))

    t_left = poolplan.left_threshold(total)
    if caller == 'hiccups':
        allowed = poolplan.device_allowed_hiccups(a_k, total, t_left, plan,
                                                  cfg.ww)
    else:
        allowed = poolplan.device_allowed_bhfdr(a_k, total, t_left, plan)
        log(f'  pyBHFDR gate: counts {a_k.tolist()}, allowed '
            f'{allowed.tolist()}')
    args_b = (raw, cband, eband, cand, allowed, plan, p_list, thr)
    b_k = cuda_scan.scan_pass_b(*args_b)
    b_t = twin.scan_pass_b(*args_b)[2]
    err = 0.0
    for p in p_list:
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            if not torch.equal(b_k[p][t], b_t[p][t]):
                raise AssertionError(f'pass B capture p={p} {name} differs '
                                     f'by up to {max_abs(b_k[p][t], b_t[p][t])}')
            err = max(err, max_abs(b_k[p][t], b_t[p][t]))
    out['scan_pass_b'] = dict(
        max_abs_err=err,
        **kernel_time(lambda: cuda_scan.scan_pass_b(*args_b), reps),
        plain_ms=kernel_time(lambda: twin.scan_pass_b(*args_b), reps)['ms'],
        library_ms=None,
        # three f32 bands, the bool mask and gate in, 4 f32 planes per p
        # out; per position and radius 10 adds for each of cband and eband
        # (Vx, Wx, Vn, Wq, ringK, ringQ) and 3 for raw, per candidate the
        # plan's background (4 sums) and Reads adds
        **bound_ms(bytes_=(13 + 16 * len(p_list)) * positions + len(plan),
                   ops=23 * maxw * positions
                   + (4 * bg_adds + reads_adds) * n_cand))

    if caller == 'bhfdr':
        # global BH is plain torch (no kernel): its fixed point on the
        # donut captures, with one host sync per step
        E, O, _, _, scored, _ = score.expected_observed(
            raw, cband, ops['IR'], Bprod, b_k[cfg.pw][0], b_k[cfg.pw][1],
            cfg.ww, cand, bands.L)
        pval = torch.where(scored, score.poisson_sf(O, E), 1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        keep, m, iterations = score.global_bh_keep(pval, scored,
                                                   cfg.siglevel)
        n_keep = int(keep.sum())
        log(f'  global BH: {iterations} fixed-point steps in '
            f'{(time.perf_counter() - t0) * 1e3:.2f} ms, m = {int(m)}, '
            f'keep superset {n_keep}')
    else:
        # the histogram's inputs as the batched scorer forms them
        pairs = list(zip(cfg.pw, cfg.ww))
        BSV = torch.stack([b_k[p][0] for p, _ in pairs]
                          + [b_k[p][2] for p, _ in pairs])
        BEV = torch.stack([b_k[p][1] for p, _ in pairs]
                          + [b_k[p][3] for p, _ in pairs])
        wis = torch.tensor([w for _, w in pairs] * 2, dtype=torch.int32,
                           device=raw.device)[:, None, None]
        E, O, _, _, scored, _ = score.expected_observed(
            raw, cband, ops['IR'], Bprod, BSV, BEV, wis, cand, bands.L)
        cid, _, valid = score.lambda_chunks(E, scored)
        o_cap = engine._bh_plan(bands.max_count)
        S, C = score.chunk_rows(o_cap, cfg.siglevel), o_cap + 1
        oc = torch.clamp(torch.floor(O), 0, C - 1).to(torch.int32) \
            .reshape(-1)
        cid0 = torch.where(valid, torch.clamp(cid, 1, S - 1), 0) \
            .reshape(E.shape[0], -1).contiguous()
        if keep is not None:
            keep.update(oc=oc, cid0=cid0, S=S, C=C)
        out['chunk_hist'] = hist_check(oc, cid0, S, C, reps)
    for name, r in out.items():
        lib = '' if r['library_ms'] is None else \
            f', library call {r["library_ms"]:.3f} ms'
        log(f'  {name}: kernel == twin (max abs err {r["max_abs_err"]}); '
            f'kernel {r["ms"]:.4f} ms ({timing(r)}), twin '
            f'{r["plain_ms"]:.3f} ms{lib}; '
            f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}: {r["bytes"]} B, '
            f'{r["ops"]} ops), {r["bound_ms"] / r["ms"]:.1%} of it')
    return out


def completion_checks(call, reps, tag):
    """The float64 completion's kernels (``ops/cuda_complete``:
    ``window_stats64``, then ``finish64``) on the inputs the main path's
    own ``call`` gave them, each against its twin bit for bit (the
    statistics and cells, then the kept flags, the counts and the audit,
    and the kept rows).  Raises on any disagreement; returns {name:
    {max_abs_err, ms, plain_ms (the twin's host time), library_ms (None:
    no library call does this), bound_ms, bound_by, bytes, ops}}."""
    import torch
    from hicpeaks_tpu_torch.ops import cuda_complete as cc
    real = {n: getattr(cc, n) for n in ('window_stats64', 'finish64')}
    seen = {}

    def keeping(n):
        def run(*a):
            seen[n] = a
            return real[n](*a)
        run.launches = 0    # the wrapper counts as it stands in for it
        return run
    for n in real:
        setattr(cc, n, keeping(n))
    try:
        call()
    finally:
        for n, fn in real.items():
            setattr(cc, n, fn)
    if set(seen) != set(real):
        raise AssertionError(f'{tag}: the main path called {sorted(seen)} '
                             'of the completion\'s kernels')

    def host(rec):
        """The record's tensors on the host (the postcheck's prod, which
        neither kernel reads, left out)."""
        return type(rec)._make(
            host(a) if isinstance(a, tuple) else
            a.cpu() if isinstance(a, torch.Tensor) else None for a in rec)

    def host_ms(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def same(a, b):
        return torch.equal(a.cpu().view(torch.int64) if a.is_floating_point()
                           else a.cpu(),
                           b.view(torch.int64) if b.is_floating_point()
                           else b)

    raw, ctx, bgs, out = seen['window_stats64']
    out_f, _, _, ptab, sig = seen['finish64']
    hist, sus = out.hist, out.sus
    _, S, C = hist.shape
    ws_args = (raw, ctx, bgs, out)
    ws_twin = (ctx, bgs, host(out))
    stats, cell = real['window_stats64'](*ws_args)
    w_stats, w_cell = cc.window_stats64_twin(*ws_twin)
    if not (same(stats, w_stats) and same(cell, w_cell)):
        raise AssertionError(f'{tag}: window_stats64 differs from its twin')
    fin_args = (out_f, cell, stats, ptab, sig)
    fin_twin = (host(out_f), w_cell, w_stats, ptab.cpu(), sig)
    rows, fin, head = real['finish64'](*fin_args)
    w_rows, w_fin, w_head = cc.finish64_twin(*fin_twin)
    if not (same(fin, w_fin) and same(head, w_head)
            and same(rows[fin], w_rows[w_fin])):
        raise AssertionError(f'{tag}: finish64 differs from its twin')

    # bytes moved once: the union of the live pixels' windows of the band
    # (float32), their (d, x) in and the statistics and cell out; float64
    # operations: a multiply pair and an add pair a cell of the
    # background's ring family (non-cross cells for 'K', 4 w^2; the
    # lower-left quadrant for 'Y', w^2)
    w = ctx.maxw
    num_p, Lp = raw.shape
    B, N = cell.shape
    K = out.d.shape[1]
    live = torch.zeros((B, N), dtype=torch.bool, device=raw.device)
    for off, pixels in ((0, out), (K, sus)):
        live[:, off:off + pixels.d.shape[1]] = (
            torch.arange(pixels.d.shape[1], device=raw.device)[None]
            < pixels.cnt.to(raw.device)[:, None])
    d_all = torch.cat([out.d, sus.d], 1)[live].long()
    x_all = torch.cat([out.x, sus.x], 1)[live].long()
    a, b = torch.meshgrid(torch.arange(-w, w + 1, device=raw.device),
                          torch.arange(-w, w + 1, device=raw.device),
                          indexing='ij')
    dp = d_all[:, None] + (b - a).reshape(-1)[None]
    tp = x_all[:, None] + a.reshape(-1)[None]
    inb = (dp >= 0) & (dp < num_p) & (tp >= 0) & (tp < Lp)
    window = torch.unique(dp[inb] * Lp + tp[inb]).numel()
    n_live = [int(v) for v in live.sum(1)]
    family = sum(n * (w * w if kind == 'Y' else 4 * w * w)
                 for n, (_, kind) in zip(n_live, bgs))
    out = {'window_stats64': dict(
        max_abs_err=0.0,
        **kernel_time(lambda: real['window_stats64'](*ws_args), reps),
        plain_ms=host_ms(lambda: cc.window_stats64_twin(*ws_twin)),
        library_ms=None,
        **bound_ms(bytes_=4 * window + 44 * sum(n_live),
                   ops=4 * family, ops_per_s=F64_OPS_PER_S))}
    # the histogram and the p table in, the cells in, the kept flags out,
    # and each kept row's statistics in and its 7 float64 out
    n_kept = int(head[0].sum())
    out['finish64'] = dict(
        max_abs_err=0.0,
        **kernel_time(lambda: real['finish64'](*fin_args), reps),
        plain_ms=host_ms(lambda: cc.finish64_twin(*fin_twin)),
        library_ms=None,
        **bound_ms(bytes_=hist.numel() * 4 + ptab.numel() * 8
                   + cell.numel() * 5 + n_kept * (24 + 56),
                   ops=0))
    for name, r in out.items():
        log(f'{tag} {name}: kernel == twin on the main path\'s inputs '
            f'({sum(n_live)} pixel slots, {n_kept} kept, S = {S}, C = {C}); '
            f'kernel {r["ms"]:.4f} ms ({timing(r)}), twin on the host '
            f'{r["plain_ms"]:.3f} ms; bound {r["bound_ms"]:.4f} ms '
            f'({r["bound_by"]}: {r["bytes"]} B, {r["ops"]} ops), '
            f'{r["bound_ms"] / r["ms"]:.1%} of it')
    return out


def score_checks(call, reps, tag):
    """The batched pyHICCUPS scorer's fused kernels (``ops/cuda_score``:
    ``score_observe``, ``score_keep``, then ``score_gather`` on the two
    compactions) on the arguments the main path's own ``call`` gave the
    scorer, each against its twin (the eager chain, on the card) bit for
    bit, timed beside its bound.  Raises on any disagreement; returns
    {name: {max_abs_err, ms, single_ms, batched_ms, plain_ms (the twin's
    CUDA-event time), library_ms (None), bound_ms, bound_by, bytes,
    ops}}."""
    import torch
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.ops import cuda_score as cs
    from hicpeaks_tpu_torch.ops import score
    seen = []
    real = engine._compact_batched

    def keeping(*a, **kw):
        seen.append((a, kw))
        return real(*a, **kw)
    engine._compact_batched = keeping
    try:
        call()
    finally:
        engine._compact_batched = real
    if len(seen) != 1:
        raise AssertionError(f'{tag}: the main path scored {len(seen)} '
                             'times in the batched scorer')
    (sh, SV, EV, wis, sig, o_cap), kw = seen[0][0][:6], seen[0][1]
    S, C, margin = kw['s_rows'], o_cap + 1, kw['margin']
    B, (num_p, Lp) = len(SV), sh.raw.shape
    n = num_p * Lp

    def same(got, want):
        return len(got) == len(want) and all(
            g.dtype == w.dtype and torch.equal(g, w)
            for g, w in zip(got, want))
    args = {'score_observe': (sh, SV, EV, wis, margin, S, C)}
    oc, cid0, flags = got = cs.score_observe(*args['score_observe'])
    if not same(got, cs.score_observe_twin(*args['score_observe'])):
        raise AssertionError(f'{tag}: score_observe differs from its twin')
    hist = score.chunk_hist(oc, cid0, S, C)
    _, thr2 = score.chunk_thresholds(hist, B, S, sig, engine._BH_SLACK,
                                     torch.float32)
    args['score_keep'] = (sh.raw, sh.gap_drop, cid0, flags, thr2, sig, C,
                          True)
    masks = cs.score_keep(*args['score_keep'])
    if not same(masks, cs.score_keep_twin(*args['score_keep'])):
        raise AssertionError(f'{tag}: score_keep differs from its twin')
    kept, sus = (score.compact_mask_batched(m)[1:] for m in masks)
    args['score_gather'] = (sh, SV, EV, wis, kept, sus, C)
    if not same(cs.score_gather(*args['score_gather']),
                cs.score_gather_twin(*args['score_gather'])):
        raise AssertionError(f'{tag}: score_gather differs from its twin')
    slots = B * (kept[0].shape[1] + sus[0].shape[1])
    # bytes the inputs need, each moved once: the band, the candidate mask
    # and IR; the 32-byte sectors of Bprod that hold a candidate, and of
    # each background's EV (SV) planes that hold a candidate at or beyond
    # its radius (and EV != 0); out, the shared count and each
    # background's chunk and flag.  Then the band, the gap filter and each
    # background's flags in, and the 32-byte sectors of its chunks that
    # hold a valid pixel (the only ones read), the thresholds, the keep
    # and suspect masks out; then
    # each slot's indices and the sheets' and planes' values at it in
    # (29 B), its outputs out (16 B at most).  Operations: about ten
    # float32 ones a background and scored pixel (a quotient, three
    # products, the log and its scaling, the floor, the edge and suspect
    # tests)
    def sectors(mask):
        return 32 * int(mask.reshape(-1, 8).any(1).sum())
    drow = torch.arange(num_p, device=sh.raw.device)[:, None]
    read = sectors(sh.cand)
    for ev, wi in zip(EV, wis):
        live = sh.cand & (drow >= wi)
        read += sectors(live) + sectors(live & (ev != 0))
    scored = int((flags & cs.SCORED).ne(0).sum())
    chunks = sum(sectors((f & cs.VALID) != 0) for f in flags)
    work = {'score_observe': (9 * n + 4 * num_p + read + 5 * B * n,
                              10 * scored),
            'score_keep': (5 * n + 3 * B * n + chunks + 4 * B * S, 0),
            'score_gather': (45 * slots, 10 * slots)}
    out = {}
    for name, a in args.items():
        kernel, twin = getattr(cs, name), getattr(cs, f'{name}_twin')
        out[name] = dict(
            max_abs_err=0.0,
            **kernel_time(lambda: kernel(*a), reps),
            plain_ms=kernel_time(lambda: twin(*a), max(3, reps // 3))['ms'],
            library_ms=None,
            **bound_ms(bytes_=work[name][0], ops=work[name][1]))
    for name, r in out.items():
        log(f'{tag} {name}: kernel == twin on the main path\'s inputs (B = '
            f'{B}, {n} pixels, {slots} gathered slots); kernel '
            f'{r["ms"]:.4f} ms ({timing(r)}), twin (the eager chain) '
            f'{r["plain_ms"]:.3f} ms; bound {r["bound_ms"]:.4f} ms '
            f'({r["bound_by"]}: {r["bytes"]} B, {r["ops"]} ops), '
            f'{r["bound_ms"] / r["ms"]:.1%} of it')
    return out


def dense_inputs(bands, w, bias_vec, d_lo):
    """The float64 oracle's dense inputs for the chromosome (bench.py's
    construction): raw and balanced upper bands, the distance-expected IR
    of diagonals d >= ``d_lo`` and the bias vector."""
    import numpy as np
    Lc, num_c = int(bands.L), int(bands.num)
    raw64 = np.asarray(bands.raw[:, :Lc], np.float64)
    w64 = np.asarray(w, np.float64)
    Md = np.zeros((Lc, Lc))
    cMd = np.zeros((Lc, Lc))
    IR_d = {}
    idx = np.arange(Lc)
    for d in range(num_c):
        Md[idx[:Lc - d], idx[:Lc - d] + d] = raw64[d, :Lc - d]
    for d in range(d_lo, num_c):
        # sparse-fetch semantics: an unstored pixel is 0.0 in the balanced
        # diagonal and enters the IR mean; NaN marks stored pixels at
        # invalid-weight bins only
        rr = raw64[d, :Lc - d]
        cdiag = rr * w64[:Lc - d] * w64[d:Lc]
        cdiag[rr == 0] = 0.0
        mask = np.isnan(cdiag)
        IR_d[d] = cdiag[~mask].mean()
        cMd[idx[:Lc - d], idx[:Lc - d] + d] = np.where(mask, 0.0, cdiag)
    B = np.where(bias_vec > 0, bias_vec, 0.0)
    return dict(Md=Md, cMd=cMd, B=B, IR=IR_d, L=Lc, num=num_c)


def oracle_table(dense, cfg, caller='hiccups', res=RES):
    """The float64 oracle's table on the dense inputs of
    :func:`dense_inputs` at bin size ``res``."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from oracle import reference_impl as oracle_mod
    args = (dense['Md'], dense['cMd'], dense['B'], dense['B'], dense['IR'],
            dense['L'], dense['num'])
    if caller == 'bhfdr':
        return oracle_mod.bhfdr(*args, pw=cfg.pw, ww=cfg.ww,
                                sig=cfg.siglevel, maxww=cfg.maxww,
                                maxapart=cfg.maxapart, res=res,
                                min_marginal_peaks=cfg.min_marginal_peaks,
                                onlyanchor=cfg.only_anchors)
    return oracle_mod.hiccups(
        *args, pw=cfg.pw, ww=cfg.ww, sig=cfg.siglevel, sumq=cfg.sumq,
        maxww=cfg.maxww, maxapart=cfg.maxapart, res=res,
        min_marginal_peaks=cfg.min_marginal_peaks,
        min_local_reads=cfg.min_local_reads, onlyanchor=cfg.only_anchors)


def bhfdr_bedpe_lines(table):
    """The sorted 13-column bedpe lines the pyBHFDR CLI writes for a
    table."""
    from hicpeaks_tpu_torch.io.peakfile import write_bhfdr_bedpe
    buf = io.StringIO()
    write_bhfdr_bedpe(buf, '1', RES, table)
    return sorted(buf.getvalue().splitlines())


def compare_to_oracle(table, want, rtol=1e-8, p_floor=0.0):
    """Raise unless loci and geometry are identical and every statistic
    is within ``rtol`` relative of ``want``'s, but for each (p, q) whose
    p in ``want`` lies below ``p_floor`` (see P_FLOOR); returns the max
    relative difference of what was compared."""
    import numpy as np
    if set(table) != set(want):
        raise AssertionError(
            f'loci differ: extra {sorted(set(table) - set(want))[:5]} '
            f'missing {sorted(set(want) - set(table))[:5]}')
    max_rel = 0.0
    for k in want:
        if tuple(table[k][:3]) != tuple(want[k][:3]):
            raise AssertionError(f'{k}: geometry {table[k][:3]} != '
                                 f'{want[k][:3]}')
        g = np.asarray(table[k][3:], float)
        v = np.asarray(want[k][3:], float)
        # (p, q) columns of the stats (O, Fold, p, q[, FoldY, pY, qY])
        compared = np.ones(len(v), bool)
        for ip in (2, 5)[:len(v) // 3]:
            if v[ip] < p_floor:
                if not g[ip] < 10 * p_floor:
                    raise AssertionError(f'{k}: p {g[ip]} against the '
                                         f'oracle\'s {v[ip]}')
                compared[ip:ip + 2] = False
        rel = np.abs(g - v)[compared] / np.maximum(np.abs(v[compared]),
                                                    1e-30)
        max_rel = max(max_rel, float(rel.max(initial=0.0)))
        if not (rel <= rtol).all():
            raise AssertionError(f'{k}: stats {g.tolist()} against '
                                 f'{v.tolist()}: beyond rtol {rtol}')
    return max_rel


def run_counted(counters, call):
    """``call()`` with every kernel's launch count set to 0 just before it;
    returns (result, seconds, {kernel: launches})."""
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = call()
    dt = time.perf_counter() - t0
    return out, dt, {fn.__name__: fn.launches for fn in counters}


def steady_walls(counters, call, n_cand, tag):
    """Two calls, the first with the launch counts read around it; logs
    both walls, the second (steady) one as candidate pixels per second,
    and the peak device memory.  Returns the first call's launches and
    the table."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    _, first, launches = run_counted(counters, call)
    t0 = time.perf_counter()
    table = call()
    steady = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'{tag} walls {first:.3f} s, {steady:.3f} s; steady '
        f'{steady:.3f} s = {n_cand / steady:.4g} candidate px/s; '
        f'{len(table)} peaks; peak device memory {peak_gb:.2f} GiB; kernel '
        f'launches of the first call {launches}')
    return launches, table


def chr1_hist_streams(device, depth):
    """The histogram's inputs at chr1 scale (phase 4's synthesis, seed 42,
    10 Mb) synthesized at ``depth``, with the kernel checks of phase 2 on
    its sheets (3 repeats); returns {oc, cid0, S, C}."""
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import HiccupsConfig
    maxapart = 10_000_000
    num = maxapart // RES + MAXWW + 1
    t0 = time.perf_counter()
    bands, _, _ = synth_bands(24900, maxapart, seed=42, n_loops=2000,
                              span=num - MAXWW - 54, lane_pad=4096,
                              depth=depth)
    cfg = HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW, maxapart=maxapart)
    log(f'  chr1 at depth {depth}: bands {bands.raw.shape}, max count '
        f'{bands.max_count:.0f}, o_cap {engine._bh_plan(bands.max_count)}, '
        f'{bands.candidate_total(min(WW), maxapart // RES)} candidates '
        f'(synthesized in {time.perf_counter() - t0:.1f} s)')
    streams = {}
    kernel_checks(bands, cfg, device, reps=3, keep=streams)
    return streams


def cap_hist_streams(streams_b, device):
    """Shape (c): (b)'s ids with counts drawn log-uniformly over
    [0, 131072] (numpy, seed 7), at the histogram's count cap."""
    import numpy as np
    import torch
    from hicpeaks_tpu_torch.ops import score
    o_cap = 1 << 17
    oc = np.floor(np.exp(np.random.default_rng(7).random(
        streams_b['oc'].numel()) * np.log(o_cap + 2))) - 1
    return dict(oc=torch.from_numpy(np.minimum(oc, o_cap).astype(np.int32))
                .to(device), cid0=streams_b['cid0'],
                S=score.chunk_rows(o_cap), C=o_cap + 1)


def deep_data(streams_a, device, counters):
    """Phase 7: the histogram at three count caps, B = 2 on the chr1 band,
    then the main path on the bench-shape chromosome at DEEP_DEPTH against
    the float64 oracle.  (a) is phase 4's streams (o_cap 1024); (b) the
    same chromosome synthesized at DEEP_DEPTH, whose largest count plans
    o_cap 16384; (c) :func:`cap_hist_streams`.  Returns ({shape: record},
    the deep main path's launches)."""
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import HiccupsConfig

    log('[7] deep data')
    streams_b = chr1_hist_streams(device, DEEP_DEPTH)
    streams_c = cap_hist_streams(streams_b, device)
    shapes = {}
    for tag, st in (('a', streams_a), ('b', streams_b), ('c', streams_c)):
        r = hist_check(st['oc'], st['cid0'], st['S'], st['C'], reps=20)
        r.update(B=st['cid0'].shape[0], n=st['oc'].numel(), S=st['S'],
                 C=st['C'], o_max=int(st['oc'].max()))
        shapes[tag] = r
        log(f'[7] histogram ({tag}) B={r["B"]} n={r["n"]} S={r["S"]} '
            f'C={r["C"]}: kernel == twin == torch.bincount; kernel '
            f'{r["ms"]:.4f} ms ({timing(r)}), twin {r["plain_ms"]:.3f} ms, '
            f'torch.bincount '
            f'{r["library_ms"]:.3f} ms; bound {r["bound_ms"]:.4f} ms '
            f'({r["bytes"]} B), {r["bound_ms"] / r["ms"]:.1%} of it')
    del streams_b, streams_c
    log(json.dumps({'chunk_hist_shapes': shapes}))

    # the main path on the bench-shape chromosome at the raised depth
    maxapart = 2_000_000
    num = maxapart // RES + MAXWW + 1
    bands, w, bias_vec = synth_bands(
        8192, maxapart, seed=0, n_loops=200, span=min(200, num - MAXWW - 2),
        lane_pad=128, depth=DEEP_DEPTH)
    o_cap = engine._bh_plan(bands.max_count)
    if o_cap < 2048:
        raise AssertionError(f'the deep bench shape plans o_cap {o_cap}, '
                             'the shared-table size of shallow data')
    cfg = HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW, maxapart=maxapart)
    table, t_main, launches = run_counted(
        counters, lambda: engine.hiccups_chrom(bands, cfg, device=device))
    log(f'[7] deep bench shape (depth {DEEP_DEPTH}, max count '
        f'{bands.max_count:.0f}, o_cap {o_cap}): hiccups_chrom in '
        f'{t_main:.2f} s (first call), {len(table)} peaks; kernel launches '
        f'{launches}')
    idle = [n for n, c in launches.items()
            if c < 1 and n not in POSTCHECK_ONLY]
    if idle:
        raise AssertionError(f'deep main path did not launch {idle}')
    t0 = time.perf_counter()
    want = oracle_table(dense_inputs(bands, w, bias_vec, min(WW)), cfg)
    max_rel = compare_to_oracle(table, want)
    log(f'[7] oracle ({time.perf_counter() - t0:.1f} s): {len(want)} peaks; '
        f'loci identical, geometry identical, max rel stat diff {max_rel:.3g}')
    return shapes, launches


def crossing_bands(seed=1):
    """Phase 8f's chromosome: chr1 at 1 kb (CROSSING_L bins) under
    pyBHFDR's CLI span (2 Mb, maxww 10), built diagonal by diagonal
    straight into its band: Poisson counts around ``CROSSING_DEPTH * (1 +
    d)^-0.75 * b[x] * b[x + d]`` (log-normal coverage, 2 % gap bins, 400
    loops of strength 4 on a 3x3 footprint), with every vector the engine
    and the float64 completion read, computed per diagonal in float64
    (ops/band.build_bands' definitions)."""
    import numpy as np
    from hicpeaks_tpu_torch.ops.band import ChromBands
    L, res, maxapart = CROSSING_L, CROSSING_RES, 2_000_000
    num = maxapart // res + MAXWW + 1
    num_p, Lp = -(-num // 8) * 8, -(-L // 4096) * 4096
    rng = np.random.default_rng(seed)
    b = np.exp(rng.normal(0.0, 0.35, size=L))
    for g in rng.integers(0, L, size=L // 200):
        b[g:g + 4] = 0.0
    w = np.full(L, np.nan)
    w[b > 0] = 1.0 / b[b > 0]
    w0 = np.where(b > 0, w, 0.0)
    loops = {}
    for x, d in zip(rng.integers(0, L - maxapart // res, size=400),
                    rng.integers(20, num - MAXWW - 2, size=400)):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                loops.setdefault(d + dy - dx, []).append(
                    (x + dx, 4.0 if dx == dy == 0 else 1.8))
    raw = np.zeros((num_p, Lp), np.float32)
    IR = np.zeros(num_p)
    colsum = np.zeros(Lp)
    cand_hist = np.zeros(num_p, np.int64)
    nanw = np.zeros(Lp, bool)
    nanw[:L] = np.isnan(w)
    for d in range(num):
        n = L - d
        lam = CROSSING_DEPTH * (1.0 + d) ** -0.75 * b[:n] * b[d:]
        for x, f in loops.get(d, ()):
            if 0 <= x < n:
                lam[x] *= f
        ct = rng.poisson(lam).astype(np.float32)
        raw[d, :n] = ct
        cv = ct * w[:n] * w[d:]
        bad = np.isnan(cv) & (ct != 0)
        cv[np.isnan(cv)] = 0.0
        cand_hist[d] = np.count_nonzero(ct)
        if d >= WW[0]:
            IR[d] = cv.sum() / (n - np.count_nonzero(bad))
            colsum[:n] += cv
    return ChromBands(
        raw=raw, IR=IR.astype(np.float32), bias=np.pad(
            np.where(b > 0, b, 0.0), (0, Lp - L)).astype(np.float32),
        w0=np.pad(w0, (0, Lp - L)).astype(np.float32), gap=colsum == 0,
        L=L, num=num, res=res, chrom='1', ww_min=WW[0], nanw=nanw,
        cand_hist=cand_hist, max_count=float(raw.max()), IR64=IR,
        bias64=np.pad(np.where(b > 0, b, 0.0), (0, Lp - L)),
        w064=np.pad(w0, (0, Lp - L)))


def staged(call, module, names):
    """``call()`` with each function ``names`` of ``module`` timed by the
    host clock between device syncs; returns (its result, wall s, {name:
    s}).  The stages nest in no other stage."""
    import torch
    real = {n: getattr(module, n) for n in names}
    spent = dict.fromkeys(names, 0.0)

    def timed(n):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[n](*a, **k)
            torch.cuda.synchronize()
            spent[n] += time.perf_counter() - t0
            return out
        return run
    for n in names:
        setattr(module, n, timed(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(module, n, real[n])
    return out, wall, spent


def crossing(device, counters):
    """Phase 8f: :func:`crossing_bands` through ``bhfdr_chrom`` on the
    host-gate route (asserted), its stages, then the scan kernels against
    their twins on its sheets and gate (pass A on the whole band, pass B's
    full-width launch against the twin in column strips), each kernel
    timed on the whole band beside its bound.  Returns ({kernel: record},
    launches)."""
    import gc
    import torch
    from hicpeaks_tpu_torch.core import engine, poolplan
    from hicpeaks_tpu_torch.core.config import BHFDRConfig
    from hicpeaks_tpu_torch.ops import cuda_scan, score
    from hicpeaks_tpu_torch.ops import scan as twin
    t0 = time.perf_counter()
    bands = crossing_bands()
    bcfg = BHFDRConfig(pw=PW[0], ww=WW[0], maxww=MAXWW, maxapart=2_000_000)
    d_hi = bcfg.maxapart // bands.res
    total = bands.candidate_total(bcfg.ww, d_hi)
    log(f'[8f] crossing: chr1 at 1 kb, bands {bands.raw.shape} '
        f'({bands.raw.size} cells), {total} candidates, 10 * total = '
        f'{10 * total} (2^31 = {1 << 31}), max count '
        f'{bands.max_count:.0f} (built per diagonal in '
        f'{time.perf_counter() - t0:.1f} s)')
    if 10 * total < engine._GATE_LIMIT:
        raise AssertionError('the 1 kb chromosome does not cross 2^31')
    route = engine.resolve_route('auto', 'auto', False, total)
    if route.device_gate:
        raise AssertionError(f'the crossing took route {route}')
    launches, table = steady_walls(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, device=device),
        total, '[8f] bhfdr_chrom (host gate)')
    idle = [n for n in ('scan_pass_a', 'scan_pass_b') if launches[n] < 1]
    if idle:
        raise AssertionError(f'the crossing did not launch {idle}')
    # a third call by stage: copy, front (sheets, pass A, host gate, pass
    # B), device scorer, host float64 completion, clustering; the rest is
    # the fetch and the host glue.  A fourth call, by stage too, with the
    # objects the process holds frozen out of the collector's reach: the
    # clustering allocates millions of small containers, and each full
    # collection they set off walks every object earlier work left alive
    def by_stage(what):
        full = gc.get_stats()[2]['collections']
        tracked, frozen = len(gc.get_objects()), gc.get_freeze_count()
        _, wall, spent = staged(
            lambda: engine.bhfdr_chrom(bands, bcfg, device=device), engine,
            ('bands_to_device', '_scan_front', '_score_device_bhfdr_compact',
             '_bhfdr_to_host', 'local_clustering'))
        log(f'[8f] stages of {what} ({wall:.3f} s; {tracked} objects '
            f'tracked, {frozen} frozen; '
            f'{gc.get_stats()[2]["collections"] - full} full collections): '
            + ', '.join(f'{n} {t:.3f} s' for n, t in spent.items())
            + f', rest {wall - sum(spent.values()):.3f} s')
    by_stage('a third call')
    gc.collect()
    gc.freeze()
    try:
        by_stage('a fourth call, earlier objects frozen')
    finally:
        gc.unfreeze()
    plan = tuple(poolplan.bhfdr_pool_plan(bcfg.pw, bcfg.ww, bcfg.maxww))
    p_list, thr = (bcfg.pw,), engine._BHFDR_THR
    ops = engine.bands_to_device(bands, device)
    raw, cband, eband, _, _, cand = score.build_sheets(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        bands.ww_min, bands.L, bcfg.ww, d_hi, bcfg.ww)
    del ops
    a_k = cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr)
    a_t = twin.scan_pass_a(raw, cand, plan, p_list, thr)
    if not torch.equal(a_k, a_t):
        raise AssertionError(f'1 kb pass A counts differ: kernel '
                             f'{a_k.tolist()} twin {a_t.tolist()}')
    allowed = torch.tensor(poolplan.emulate_freeze_bhfdr(
        plan, a_k.cpu().numpy(), total).allowed, device=raw.device)
    log(f'  1 kb gate: counts {a_k.tolist()}, allowed {allowed.tolist()}')
    args_b = (raw, cband, eband, cand, allowed, plan, p_list, thr)
    # the full-width launch against the twin in strips of STRIP columns:
    # a capture reads at most maxw columns either side, so each strip's
    # twin runs on the strip with 2 * maxw columns of halo and is compared
    # off the halo
    maxw = cuda_scan.max_ring(plan)
    b_k = cuda_scan.scan_pass_b(*args_b)[bcfg.pw]
    Lp = raw.shape[1]
    for x0 in range(0, Lp, STRIP):
        x1, lo = min(x0 + STRIP, Lp), max(x0 - 2 * maxw, 0)
        strip = tuple(a[:, lo:min(x1 + 2 * maxw, Lp)].contiguous()
                      for a in (raw, cband, eband, cand))
        b_t = twin.scan_pass_b(*strip, *args_b[4:])[2][bcfg.pw]
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            if not torch.equal(b_k[t][:, x0:x1],
                               b_t[t][:, x0 - lo:x1 - lo]):
                raise AssertionError(f'1 kb pass B capture {name} differs '
                                     f'in columns [{x0}, {x1})')
        del strip, b_t
    del b_k
    positions, n_cand = raw.numel(), int(cand.sum())
    reads_adds = sum(len(e.reads_rings) for e in plan)
    bg_adds = sum(len(e.bg_rings) for e in plan)
    out = dict(
        scan_pass_a=dict(max_abs_err=0.0, **kernel_time(
            lambda: cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr), 3),
            **bound_ms(bytes_=5 * positions + 4 * len(plan),
                       ops=3 * maxw * positions + reads_adds * n_cand)),
        scan_pass_b=dict(max_abs_err=0.0, **kernel_time(
            lambda: cuda_scan.scan_pass_b(*args_b), 3),
            **bound_ms(bytes_=(13 + 16 * len(p_list)) * positions
                       + len(plan),
                       ops=23 * maxw * positions
                       + (4 * bg_adds + reads_adds) * n_cand)))
    for name, r in out.items():
        log(f'  1 kb {name}: kernel == twin; kernel {r["ms"]:.3f} ms; bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}: {r["bytes"]} B, '
            f'{r["ops"]} ops), {r["bound_ms"] / r["ms"]:.1%} of it')
    log(f'[8f] crossing: {len(table)} peaks; pass A and the full-width '
        f'pass B bit-equal to their twins ({-(-Lp // STRIP)} strips)')
    return out, launches


def ladder(bench_bands, cfg, bcfg, want_h, want_b, chr1, device, counters):
    """Phase 8: the fallback ladder's routes on the card (module
    docstring).  ``chr1`` = (bands, cfg, fused table) of phase 4.
    Returns ({route tag: launches}, the crossing's kernel records)."""
    import numpy as np
    from hicpeaks_tpu_torch.core import engine
    runs = {}

    def run(tag, fn, bands, c, want, rtol=1e-8, p_floor=0.0, **kw):
        table, dt, runs[tag] = run_counted(
            counters, lambda: fn(bands, c, device=device, **kw))
        max_rel = compare_to_oracle(table, want, rtol, p_floor)
        log(f'[8{tag[0]}] {tag[2:]} {kw}: {dt:.2f} s (first call), '
            f'{len(table)} peaks, loci and geometry identical, max rel '
            f'{max_rel:.3g} (bar {rtol}); kernel launches {runs[tag]}')
        return table

    log('[8] the fallback ladder')
    h, b = engine.hiccups_chrom, engine.bhfdr_chrom
    run('a_hiccups_validate', h, bench_bands, cfg, want_h,
        scan_backend='validate')
    run('a_bhfdr_validate', b, bench_bands, bcfg, want_b,
        scan_backend='validate')
    run('b_hiccups_host_bh', h, bench_bands, cfg, want_h, DEVICE_RTOL,
        P_FLOOR, bh_backend='host')
    run('b_bhfdr_host_bh', b, bench_bands, bcfg, want_b, DEVICE_RTOL,
        P_FLOOR, bh_backend='host')

    maxapart = cfg.maxapart
    num = maxapart // RES + MAXWW + 1
    hot, w, bias_vec = synth_bands(
        int(bench_bands.L), maxapart, seed=0, n_loops=200, span=min(200, num - MAXWW - 2),
        lane_pad=128, boost=(50, 150_000))
    t0 = time.perf_counter()
    want_hot = oracle_table(dense_inputs(hot, w, bias_vec, min(WW)), cfg)
    log(f'[8c] one pixel at 150,000 counts: max count {hot.max_count:.0f}, '
        f'o_cap {engine._bh_plan(hot.max_count)}; oracle '
        f'({time.perf_counter() - t0:.1f} s) {len(want_hot)} peaks')
    for bh in ('auto', 'host'):
        run(f'c_hiccups_{bh}', h, hot, cfg, want_hot, DEVICE_RTOL,
            P_FLOOR, bh_backend=bh)
    del hot

    for tag, fn, c, want in (('hiccups', h, cfg, want_h),
                             ('bhfdr', b, bcfg, want_b)):
        run(f'd_{tag}_check', fn, bench_bands, c, want, DEVICE_RTOL,
            P_FLOOR, check=True)
        d, x = 20, int(np.nonzero(bench_bands.raw[20])[0][100])
        keep = bench_bands.raw[d, x]
        bench_bands.raw[d, x] = np.nan
        try:
            fn(bench_bands, c, device=device, check=True)
        except FloatingPointError as e:
            log(f'[8d] {tag} with raw[{d}, {x}] = NaN raised: {e}')
        else:
            raise AssertionError(f'{tag} check=True let a NaN through')
        finally:
            bench_bands.raw[d, x] = keep

    bands, hcfg, fused = chr1
    n_cand = bands.candidate_total(min(hcfg.ww), hcfg.maxapart // RES)
    runs['e_hiccups_dense_chr1'], table = steady_walls(
        counters, lambda: h(bands, hcfg, device=device, bh_backend='host'),
        n_cand, '[8e] hiccups_chrom chr1 10 Mb, dense scorer')
    max_rel = compare_to_oracle(table, fused, DEVICE_RTOL, P_FLOOR)
    log(f'[8e] dense chr1: loci and geometry identical to the fused '
        f'route\'s {len(fused)} peaks, max rel {max_rel:.3g}')

    crossing_recs, runs['f_bhfdr_crossing'] = crossing(device, counters)
    for tag, launches in runs.items():
        # the histogram runs in the batched scorer and the one-background
        # compact scorer; the dense and segmented routes have none
        want = ('scan_pass_a', 'scan_pass_b') + (
            ('chunk_hist',) if tag in ('a_hiccups_validate',
                                       'd_hiccups_check') else ())
        idle = [n for n in want if launches[n] < 1]
        if idle:
            raise AssertionError(f'route {tag} did not launch {idle}')
        # the fused scorer's kernels serve the batched scorer alone, the
        # gather once more a postcheck
        fused = int(tag == 'a_hiccups_validate')
        got = [launches[n] for n in ('score_observe', 'score_keep',
                                     'score_gather', 'score_prod')]
        if got != [fused, fused, fused + got[3], got[3] * fused]:
            raise AssertionError(f'route {tag}: the scorer\'s kernels '
                                 f'launched {launches}, want {fused} each')
    return runs, crossing_recs


def run_module(module, args):
    """``python -m hicpeaks_tpu_torch.cli.<module> args`` in a process of
    its own from the checkout; returns (the finished process, its wall in
    seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', f'hicpeaks_tpu_torch.cli.{module}', *args],
        cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    return proc, time.perf_counter() - t0


def run_cli(module, args, log_file):
    """:func:`run_module` with ``--logFile log_file``; raises on a non-zero
    exit (with the log's tail); returns its wall in seconds."""
    proc, dt = run_module(module, [*args, '--logFile', log_file])
    if proc.returncode != 0:
        tail = open(log_file).read()[-3000:] if os.path.exists(log_file) \
            else ''
        raise AssertionError(f'{module} {args} exited {proc.returncode}:\n'
                             f'{proc.stderr[-3000:]}\n{tail}')
    return dt


def check_weights(got, want, what, bar=1e-9):
    """Same NaN mask and weights within ``bar`` relative, or raise;
    returns the max relative difference."""
    import numpy as np
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError(f'{what}: NaN masks differ')
    ok = ~np.isnan(want)
    rel = float(np.max(np.abs(got[ok] - want[ok]) / np.abs(want[ok]),
                       initial=0.0))
    if rel > bar:
        raise AssertionError(f'{what}: weights differ by {rel:.3g} relative '
                             f'(bar {bar})')
    return rel


def ingest_check(device, tmp):
    """Phase 9a: TXT -> toCooler on the card, intra-only and with
    --includeTrans, at the reference example's scale (chr21 and chr22 at
    25 kb, the full intra span), against the symmetrized input and against
    the port's ICE on the CPU."""
    import shutil
    import numpy as np
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.io.ingest import _symmetrize_upper
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom, write_txt
    from hicpeaks_tpu_torch.ops import ice
    res = 25000
    sizes = {'21': 46_709_983, '22': 50_818_468}      # hg38
    folder = os.path.join(tmp, '25K')
    os.makedirs(folder)
    want, offset = {}, 0
    rng = np.random.default_rng(21)
    for i, (c, size) in enumerate(sizes.items()):
        n = -(-size // res)
        b1, b2, ct, _, _ = synthesize_chrom(n_bins=n, res=res, seed=i,
                                            depth=12.0, n_loops=40,
                                            max_loop_span_bins=n - 64)
        # a few mirrored (lower-triangle) lines, which ingestion folds up
        flip = rng.random(b1.size) < 0.01
        b1, b2 = np.where(flip, b2, b1), np.where(flip, b1, b2)
        write_txt(os.path.join(folder, f'{c}_{c}.txt'), b1, b2, ct)
        x, y, v = _symmetrize_upper(b1, b2, ct.astype(np.float64),
                                    int(max(b1.max(), b2.max())) + 1)
        want[c] = (x + offset, y + offset, v)
        offset += n
    n21 = -(-sizes['21'] // res)
    tx = rng.integers(0, n21, 20000)
    ty = rng.integers(0, offset - n21, 20000)
    key = np.unique(tx * offset + ty)
    tx, ty = key // offset, key % offset
    tv = rng.integers(1, 5, tx.size)
    write_txt(os.path.join(folder, '21_22.txt'), tx, ty, tv)
    with open(os.path.join(tmp, 'sizes.txt'), 'w') as f:
        f.writelines(f'chr{c}\t{s}\n' for c, s in sizes.items())
    with open(os.path.join(tmp, 'meta.txt'), 'w') as f:
        f.write(f'res:{res}\n{folder}\n')
    n_px = sum(len(w[0]) for w in want.values())
    log(f'[9a] TXT: chr21 + chr22 at 25 kb, {n_px} intra and {tx.size} '
        f'trans pixels')
    out = {}
    for tag, extra in (('intra', []), ('trans', ['--includeTrans'])):
        cool = os.path.join(tmp, f'{tag}.cool')
        wall = run_cli('tocooler', ['-O', cool, '-d',
                                    os.path.join(tmp, 'meta.txt'),
                                    '--chromsizes-file',
                                    os.path.join(tmp, 'sizes.txt'),
                                    '--device', device, *extra],
                       os.path.join(tmp, f'tocooler_{tag}.log'))
        clr = CoolerLite(f'{cool}::{res}')
        b1, b2, ct = clr.pixels()
        exp = [np.concatenate([want[c][k] for c in sizes]) for k in range(3)]
        if tag == 'trans':
            order = np.lexsort((np.r_[exp[1], ty + n21],
                                np.r_[exp[0], tx]))
            exp = [np.r_[exp[0], tx][order], np.r_[exp[1], ty + n21][order],
                   np.r_[exp[2], tv][order]]
        if not all(np.array_equal(a, e) for a, e in
                   zip((b1, b2, ct), exp)):
            raise AssertionError(f'[9a] {tag}: the cooler\'s pixels are not '
                                 'the symmetrized input')
        card = clr.weights()
        again = os.path.join(tmp, f'{tag}_again.cool')
        shutil.copy(cool, again)
        ice.balance(CoolerLite(f'{again}::{res}'), device=device)
        if not np.array_equal(CoolerLite(f'{again}::{res}').weights(), card,
                              equal_nan=True):
            raise AssertionError(f'[9a] {tag}: two balances on the card '
                                 'differ')
        ice.balance(CoolerLite(f'{again}::{res}'), device='cpu')
        rel = check_weights(card, CoolerLite(f'{again}::{res}').weights(),
                            f'[9a] {tag} card against CPU')
        # n_iters of each correction, card against CPU
        if tag == 'trans':
            parts = [(clr.pixels(), clr.nbins)]
        else:
            parts = [(clr.pixels_for_chrom(c), hi - lo) for c, (lo, hi) in
                     ((c, clr.bin_range(c)) for c in clr.chromnames)]
        iters = []
        for px, n in parts:
            r_card = ice.ice_balance_genome(*px, n, device=device)
            r_cpu = ice.ice_balance_genome(*px, n, device='cpu')
            if (r_card.n_iters, r_card.converged) != \
                    (r_cpu.n_iters, r_cpu.converged):
                raise AssertionError(f'[9a] {tag}: card {r_card.n_iters} '
                                     f'iterations, CPU {r_cpu.n_iters}')
            check_weights(r_card.bias, r_cpu.bias, f'[9a] {tag} ICE')
            iters.append(r_card.n_iters)
        out[tag] = dict(wall_s=wall, pixels=int(b1.size), max_rel=rel,
                        n_iters=iters)
        log(f'[9a] toCooler {tag} on the card in {wall:.2f} s (a process '
            f'of its own): {b1.size} pixels equal the symmetrized input; '
            f'weights against the CPU max rel {rel:.3g}, n_iters {iters} '
            f'on both; a second balance on the card bit-identical')
    return out


def chr1_cooler(tmp, L=24900):
    """Phase 4's chr1 (10 kb, L = 24,900, seed 42, 2000 loops) written as
    an unbalanced cooler under ``tmp``; (URI, its pixels, write seconds)."""
    from hicpeaks_tpu_torch.io.coolerlite import binnify, create_cooler_file
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    num = 10_000_000 // RES + MAXWW + 1
    b1, b2, ct, _, _ = synthesize_chrom(
        n_bins=L, res=RES, seed=42, depth=40.0, n_loops=2000, decay=0.75,
        max_loop_span_bins=num - MAXWW - 54)
    uri = f'{os.path.join(tmp, "chr1.cool")}::{RES}'
    t0 = time.perf_counter()
    create_cooler_file(uri, binnify({'1': L * RES}, RES),
                       [{'bin1_id': b1, 'bin2_id': b2, 'count': ct}],
                       metadata={'onlyIntra': 'True'})
    return uri, (b1, b2, ct), time.perf_counter() - t0


def cli_check(device, tmp, counters, L=24900, keep=None):
    """Phase 9b: phase 4's chr1 (10 kb, L = 24,900, seed 42, 2000 loops)
    written as a cooler, balanced on the card, then both CLIs from it on
    the card against the in-process engines on the same cooler's bands.
    A dict ``keep`` receives the cooler's URI (``chr1_uri``) and the
    pyBHFDR CLI's bedpe path (``chr1_bhfdr_bedpe``)."""
    import numpy as np
    import torch
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.io.peakfile import (write_bhfdr_bedpe,
                                                write_hiccups_bedpe)
    from hicpeaks_tpu_torch.ops import ice
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler
    uri, (b1, b2, ct), t_write = chr1_cooler(tmp, L)
    cool = uri.split('::')[0]
    if keep is not None:
        keep['chr1_uri'] = uri
    t0 = time.perf_counter()
    px = CoolerLite(uri).pixels_for_chrom('1')
    t_read = time.perf_counter() - t0
    if not all(np.array_equal(a, e) for a, e in zip(px, (b1, b2, ct))):
        raise AssertionError('[9b] chr1 pixels read back differ')
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ice.balance(CoolerLite(uri), device=device)
        walls.append(time.perf_counter() - t0)
    size_mb = os.path.getsize(cool) / 2 ** 20
    log(f'[9b] chr1 at 10 kb: {b1.size} pixels written in {t_write:.2f} s '
        f'({size_mb:.1f} MiB); host read of its pixels through h5lite '
        f'{t_read:.3f} s; ICE on the card {walls[0]:.3f} s, steady '
        f'{walls[1]:.3f} s (read, balance, write)')
    out = dict(pixels=int(b1.size), write_s=t_write, read_s=t_read,
               ice_s=walls[1], ice_first_s=walls[0], file_mib=size_mb)
    clr = CoolerLite(uri)
    for tool, cfg, call, writer in (
            ('pyHICCUPS', HiccupsConfig(), engine.hiccups_chrom,
             write_hiccups_bedpe),
            ('pyBHFDR', BHFDRConfig(), engine.bhfdr_chrom,
             write_bhfdr_bedpe)):
        bedpe = os.path.join(tmp, f'{tool}.bedpe')
        wall = run_cli('peakcall', [tool, '-O', bedpe, '-p', uri, '--pw', '2',
                                    '--ww', '5', '--device', device],
                       os.path.join(tmp, f'{tool}.log'))
        # the bands the API builds for the chromosome (api._run)
        bands = bands_from_cooler(clr, '1', cfg.maxapart, cfg.maxww,
                                  cfg.ww_min, keep_sparse=False)
        table, _, launches = run_counted(
            counters, lambda: call(bands, cfg, device=device))
        want = ['scan_pass_a', 'scan_pass_b'] + (
            ['chunk_hist', 'score_observe', 'score_keep', 'score_gather']
            if tool == 'pyHICCUPS' else [])
        idle = [n for n in want if launches[n] < 1]
        if idle:
            raise AssertionError(f'[9b] {tool} in process did not launch '
                                 f'{idle}')
        buf = io.StringIO()
        writer(buf, '1', RES, table)
        with open(bedpe) as f:
            got = f.read()
        if got != buf.getvalue():
            raise AssertionError(f'[9b] the {tool} CLI\'s bedpe differs from '
                                 'the in-process engine\'s')
        out[tool] = dict(wall_s=wall, peaks=len(table), launches=launches)
        if keep is not None and tool == 'pyBHFDR':
            keep['chr1_bhfdr_bedpe'] = bedpe
        log(f'[9b] {tool} CLI on the card from the cooler in {wall:.2f} s (a '
            f'process of its own): {len(table)} peaks, bedpe byte-identical '
            f'to the in-process engine\'s (kernel launches {launches})')
    return out


HG38 = {  # chromosome lengths, GRCh38 (UCSC hg38.chrom.sizes)
    '1': 248_956_422, '2': 242_193_529, '3': 198_295_559, '4': 190_214_555,
    '5': 181_538_259, '6': 170_805_979, '7': 159_345_973, '8': 145_138_636,
    '9': 138_394_717, '10': 133_797_422, '11': 135_086_622,
    '12': 133_275_309, '13': 114_364_328, '14': 107_043_718,
    '15': 101_991_189, '16': 90_338_345, '17': 83_257_441, '18': 80_373_285,
    '19': 58_617_616, '20': 64_444_167, '21': 46_709_983, '22': 50_818_468,
    'X': 156_040_895}


def genome_check(device, tmp, counters, sizes=HG38, keep=None):
    """Phase 9c: a synthetic genome (HG38, 10 kb, pixels within 2 Mb)
    written by the port's writer, balanced on the card, then
    ``call_bhfdr`` on the card; walls by stage and by chromosome.  A dict
    ``keep`` receives the cooler's URI, the table and the bedpe path
    (``genome_uri``, ``genome_results``, ``genome_bedpe``)."""
    import logging
    import re
    import numpy as np
    import torch
    from hicpeaks_tpu_torch import api
    from hicpeaks_tpu_torch.core.config import BHFDRConfig
    from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                                  create_cooler_file)
    from hicpeaks_tpu_torch.io.peakfile import write_bhfdr_bedpe
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops import ice
    span = 2_000_000 // RES
    nbins = {c: -(-s // RES) for c, s in sizes.items()}
    t0 = time.perf_counter()
    chunks, offset = [], 0
    for i, c in enumerate(sizes):
        b1, b2, ct, _, _ = synthesize_chrom(
            n_bins=nbins[c], res=RES, seed=100 + i, depth=40.0,
            n_loops=nbins[c] // 12, decay=0.75, max_loop_span_bins=span - 64)
        chunks.append({'bin1_id': b1 + offset, 'bin2_id': b2 + offset,
                       'count': ct})
        offset += nbins[c]
    n_px = sum(len(ch['count']) for ch in chunks)
    t_synth = time.perf_counter() - t0
    cool = os.path.join(tmp, 'genome.cool')
    uri = f'{cool}::{RES}'
    t0 = time.perf_counter()
    create_cooler_file(uri, binnify(sizes, RES), chunks,
                       metadata={'onlyIntra': 'True'}, assembly='hg38')
    t_write = time.perf_counter() - t0
    del chunks
    per_ice = {}
    real = ice.ice_balance_genome

    def timed(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = real(*a, **k)
        per_ice[len(per_ice)] = time.perf_counter() - t
        return r
    ice.ice_balance_genome = timed
    try:
        t0 = time.perf_counter()
        ice.balance(CoolerLite(uri), device=device)
        t_ice = time.perf_counter() - t0
    finally:
        ice.ice_balance_genome = real
    size_mb = os.path.getsize(cool) / 2 ** 20
    log(f'[9c] genome: chromosomes {", ".join(sizes)}, '
        f'{offset} bins at 10 kb, {n_px} pixels within 2 Mb (synthesized in '
        f'{t_synth:.1f} s); written in {t_write:.2f} s ({size_mb:.1f} MiB); '
        f'ICE on the card {t_ice:.2f} s')

    records = []

    class Grab(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())
    grab = Grab(level=logging.INFO)
    alog = logging.getLogger(api.__name__)
    level = alog.level
    alog.addHandler(grab)
    alog.setLevel(logging.INFO)
    try:
        torch.cuda.reset_peak_memory_stats()
        results, t_call, launches = run_counted(
            counters, lambda: api.call_bhfdr(uri, BHFDRConfig(),
                                             device=device))
    finally:
        alog.removeHandler(grab)
        alog.setLevel(level)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    idle = [n for n in ('scan_pass_a', 'scan_pass_b') if launches[n] < 1]
    if idle or set(results) != set(sizes):
        raise AssertionError(f'[9c] call_bhfdr: chromosomes {sorted(results)}'
                             f', idle kernels {idle}')
    n_peaks = sum(len(t) for t in results.values())
    per_chrom = {}
    for msg in records:
        m = re.match(r'Chrom:(\w+), (\d+) band pixels scored in ([\d.]+)s '
                     r'\(band build ([\d.]+)s', msg)
        if m:
            per_chrom[m.group(1)] = dict(
                candidates=int(m.group(2)), call_s=float(m.group(3)),
                band_s=float(m.group(4)), peaks=len(results[m.group(1)]))
    for i, c in enumerate(sizes):
        per_chrom[c]['ice_s'] = per_ice[i]
    log(f'[9c] call_bhfdr on the card: {t_call:.2f} s, {n_peaks} peaks, '
        f'peak device memory {peak_gb:.2f} GiB, kernel launches {launches}')
    log('[9c] per chromosome (ICE s / band build s / call s / peaks): ' +
        ', '.join(f'{c} {r["ice_s"]:.3f}/{r["band_s"]:.2f}/'
                  f'{r["call_s"]:.3f}/{r["peaks"]}'
                  for c, r in per_chrom.items()))
    # the calls as the pyBHFDR CLI writes them, phase 10a's loop list
    bedpe = os.path.join(tmp, 'genome.bhfdr.bedpe')
    with open(bedpe, 'w') as f:
        for c in sizes:
            write_bhfdr_bedpe(f, c, RES, results[c])
    if keep is not None:
        keep.update(genome_uri=uri, genome_results=results,
                    genome_bedpe=bedpe)
    return dict(chroms=len(sizes), bins=offset, pixels=n_px,
                synth_s=t_synth, write_s=t_write, ice_s=t_ice,
                call_s=t_call, peaks=n_peaks, peak_gib=peak_gb,
                file_mib=size_mb, launches=launches, per_chrom=per_chrom)


def same_bits(a, b):
    """True when two float64 arrays or scalars hold the same bits."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def apa_genome(device, tmp, counters):
    """Phase 10a: APA of phase 9c's pyBHFDR calls on phase 9c's balanced
    hg38 cooler, with ``apa_stats`` on the card and on the CPU (every
    output bit-identical; walls by stage, peak device memory), then the
    apa-analysis CLI on the card in a process of its own (its printed count
    asserted; it draws the figure where matplotlib is installed)."""
    import numpy as np
    import torch
    from hicpeaks_tpu_torch.cli import apa as apa_cli
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.io.peakfile import parse_peakfile
    uri = f'{os.path.join(tmp, "genome.cool")}::{RES}'
    bedpe = os.path.join(tmp, 'genome.bhfdr.bedpe')
    clr = CoolerLite(uri)
    peaks = parse_peakfile(bedpe, 0)
    n_loops = sum(len(v) for v in peaks.values())
    runs = {}
    for tag, dev in (('card', device), ('cpu', 'cpu')):
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        got, wall, spent = staged(
            lambda: apa_cli.apa_stats(clr, peaks, device=dev), apa_cli,
            ('locate_peak_bins', 'chrom_windows'))
        runs[tag] = r = dict(
            wall_s=wall, locate_s=spent['locate_peak_bins'],
            windows_s=spent['chrom_windows'],
            rest_s=wall - sum(spent.values()),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={fn.__name__: fn.launches for fn in counters})
        log(f'[10a] apa_stats on {dev}: {wall:.2f} s (locate_peak_bins '
            f'{r["locate_s"]:.2f} s, window stage {r["windows_s"]:.3f} s, '
            f'pixel and weight reads and scoring {r["rest_s"]:.2f} s), '
            f'{got[0]} windows of {n_loops} loops, peak device memory '
            f'{r["peak_gib"]:.3f} GiB, kernel launches {r["launches"]}')
        if any(r['launches'][n] for n in ('score_observe', 'score_keep',
                                          'score_gather')):
            raise AssertionError('[10a] APA launched the scorer\'s kernels')
        r['out'] = got
    card, cpu = runs['card'].pop('out'), runs['cpu'].pop('out')
    if card[0] != cpu[0] or not all(same_bits(a, b)
                                    for a, b in zip(card[1:], cpu[1:])):
        raise AssertionError(f'[10a] APA on the card {card[0]} windows, '
                             f'score {card[2]!r}; on the CPU {cpu[0]}, '
                             f'{cpu[2]!r}: not bit-identical')
    n, _, score, z, p, maxi = card
    log(f'[10a] card and CPU bit-identical: {n} windows, avg (11, 11), '
        f'score {score!r}, z {z!r}, p {p!r}, maxi {maxi!r}')
    png = os.path.join(tmp, 'apa_card.png')
    proc, wall = run_module('apa', ['-O', png, '-p', uri, '-I', bedpe,
                                    '--device', device])
    printed = proc.stdout.split()
    if printed[:1] != [str(n)]:
        raise AssertionError(f'[10a] the apa CLI printed {printed[:1]}, '
                             f'apa_stats counted {n}:\n{proc.stderr[-3000:]}')
    if (HAS_MATPLOTLIB and proc.returncode != 0) or (
            not HAS_MATPLOTLIB
            and "No module named 'matplotlib'" not in proc.stderr):
        raise AssertionError(f'[10a] the apa CLI exited {proc.returncode}:'
                             f'\n{proc.stderr[-3000:]}')
    log(f'[10a] apa CLI --device {device} in {wall:.2f} s (a process of its '
        f'own): printed {printed[0]}'
        + ('' if HAS_MATPLOTLIB else '; no matplotlib here, no figure'))
    return dict(loops=n_loops, windows=n, score=float(score), cli_s=wall,
                **runs)


CHR21 = 46_709_983   # hg38
MULTIRES = (5000, 10000, 25000)
# pyHICCUPS's (pw, ww) at each resolution, HiCCUPS's published settings
# (Rao et al. 2014: p = 4, 2, 1 and i = 7, 5, 3 at 5, 10 and 25 kb)
MULTIRES_PW_WW = {5000: (4, 7), 10000: (2, 5), 25000: (1, 3)}
PLOT_REGION = (20_000_000, 24_000_000)   # phase 10c's peak-plot, chr21 bp


def multires_check(device, tmp, counters):
    """Phase 10b: one chr21 library binned at 5, 10 and 25 kb, balanced on
    the card, the pyHICCUPS CLI on the card at each resolution (each bedpe
    byte-identical to the in-process engine's on the cooler's bands, whose
    table is held against the float64 oracle at 10 and 25 kb; at 5 kb, a
    9,342-bin dense oracle over 2,011 diagonals is too slow), then the
    combine-resolutions CLI against ``combine_annotations``."""
    import numpy as np
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.combine import combine_annotations
    from hicpeaks_tpu_torch.core.config import HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                                  create_cooler_file)
    from hicpeaks_tpu_torch.io.peakfile import (parse_peakfile,
                                                write_combined_bedpe,
                                                write_hiccups_bedpe)
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom_multires
    from hicpeaks_tpu_torch.ops import ice
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler
    t0 = time.perf_counter()
    per_res, loops, _ = synthesize_chrom_multires(
        -(-CHR21 // MULTIRES[0]), fine_res=MULTIRES[0], resolutions=MULTIRES,
        seed=21, depth=40.0, n_loops=300, decay=0.75, loop_strength=6.0,
        max_loop_span_bins=380)
    t_synth = time.perf_counter() - t0
    cool = os.path.join(tmp, 'multires.cool')
    out = dict(synth_s=t_synth, planted=len(loops), res={})
    bedpes = []
    for res in MULTIRES:
        b1, b2, ct, n_bins = per_res[res]
        pw, ww = MULTIRES_PW_WW[res]
        cfg = HiccupsConfig(pw=(pw,), ww=(ww,))
        uri = f'{cool}::{res}'
        t0 = time.perf_counter()
        create_cooler_file(uri, binnify({'21': CHR21}, res),
                           [{'bin1_id': b1, 'bin2_id': b2, 'count': ct}],
                           metadata={'onlyIntra': 'True'})
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        ice.balance(CoolerLite(uri), device=device)
        t_ice = time.perf_counter() - t0
        bedpe = os.path.join(tmp, f'hiccups_{res}.bedpe')
        wall = run_cli('peakcall', ['pyHICCUPS', '-O', bedpe, '-p', uri,
                                    '--pw', str(pw), '--ww', str(ww),
                                    '--device', device],
                       os.path.join(tmp, f'hiccups_{res}.log'))
        clr = CoolerLite(uri)
        bands = bands_from_cooler(clr, '21', cfg.maxapart, cfg.maxww,
                                  cfg.ww_min, keep_sparse=False)
        table, t_call, launches = run_counted(
            counters, lambda: engine.hiccups_chrom(bands, cfg, device=device))
        idle = [n for n, c in launches.items()
            if c < 1 and n not in POSTCHECK_ONLY]
        if idle:
            raise AssertionError(f'[10b] {res}: hiccups_chrom did not launch '
                                 f'{idle}')
        buf = io.StringIO()
        write_hiccups_bedpe(buf, '21', res, table)
        with open(bedpe) as f:
            if f.read() != buf.getvalue():
                raise AssertionError(f'[10b] {res}: the CLI\'s bedpe differs '
                                     'from the in-process engine\'s')
        bedpes.append(bedpe)
        bar = 'the in-process engine'
        if res != MULTIRES[0]:
            t0 = time.perf_counter()
            w = clr.weights('21')
            bias = np.where(np.isnan(w), 0.0, 1.0 / w)
            want = oracle_table(dense_inputs(bands, w, bias, cfg.ww_min),
                                cfg, res=res)
            max_rel = compare_to_oracle(table, want)
            bar = (f'the float64 oracle ({time.perf_counter() - t0:.1f} s; '
                   f'loci and geometry identical, max rel {max_rel:.3g})')
        out['res'][res] = dict(bins=int(n_bins), pixels=int(b1.size),
                               pw=pw, ww=ww, write_s=t_write, ice_s=t_ice,
                               cli_s=wall, call_s=t_call, peaks=len(table),
                               launches=launches, held_against=bar)
        log(f'[10b] {res // 1000} kb (pw {pw}, ww {ww}): {n_bins} bins, '
            f'{b1.size} pixels, written {t_write:.2f} s, ICE on the card '
            f'{t_ice:.2f} s; pyHICCUPS CLI on the card {wall:.2f} s (a '
            f'process of its own), {len(table)} peaks, bedpe byte-identical '
            f'to the in-process engine\'s on the cooler\'s bands ({t_call:.2f}'
            f' s, kernel launches {launches}); table held against {bar}')
    combined = os.path.join(tmp, 'combined.bedpe')
    proc, wall = run_module('combine', [
        '-O', combined, '-p', *bedpes, '-R', *map(str, MULTIRES)])
    if proc.returncode != 0:
        raise AssertionError(f'[10b] combine exited {proc.returncode}:\n'
                             f'{proc.stderr[-3000:]}')
    # the CLI's defaults: -G 20000 -M 200000 --max-res 10000
    kept = combine_annotations(
        {r: parse_peakfile(b, 0) for r, b in zip(MULTIRES, bedpes)},
        good_res=20000, mindis=200000, max_res=10000)
    buf = io.StringIO()
    write_combined_bedpe(buf, kept)
    with open(combined) as f:
        if f.read() != buf.getvalue():
            raise AssertionError('[10b] the combine CLI\'s file differs from '
                                 'combine_annotations\'')
    # a peak finer than -G and farther apart than -M survives only when a
    # coarser call confirms it
    confirmed = sum(t[2] - t[1] < 20000 and t[4] - t[1] > 200000
                    for t in kept)
    by_res = {r: sum(t[2] - t[1] == r for t in kept) for r in MULTIRES}
    if confirmed < 1:
        raise AssertionError('[10b] no fine peak was confirmed by a coarser '
                             'one')
    out.update(combine_s=wall, combined=len(kept), confirmed=confirmed,
               combined_by_res=by_res)
    log(f'[10b] combine-resolutions CLI {wall:.2f} s: {len(kept)} loops '
        f'({by_res}), {confirmed} fine peaks confirmed by coarser calls; '
        f'file equal to combine_annotations\' on the three tables')
    return out


def figures_check(tmp):
    """Phase 10c, where matplotlib is installed: the APA figure drawn in
    process with --device cpu byte-identical to phase 10a's from the card,
    and peak-plot of a 4 Mb region of chr21 at 10 kb with the combined
    loops."""
    import contextlib
    from hicpeaks_tpu_torch.cli import apa as apa_cli
    from hicpeaks_tpu_torch.cli import peakplot
    card = os.path.join(tmp, 'apa_card.png')
    cpu = os.path.join(tmp, 'apa_cpu.png')
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = apa_cli.main(['-O', cpu, '-p',
                           f'{os.path.join(tmp, "genome.cool")}::{RES}', '-I',
                           os.path.join(tmp, 'genome.bhfdr.bedpe'),
                           '--device', 'cpu'])
    t_apa = time.perf_counter() - t0
    with open(card, 'rb') as f, open(cpu, 'rb') as g:
        a, b = f.read(), g.read()
    if rc != 0 or a != b:
        raise AssertionError(f'[10c] the APA figures differ ({len(a)} and '
                             f'{len(b)} bytes, rc {rc})')
    region = os.path.join(tmp, 'region.png')
    t0 = time.perf_counter()
    rc = peakplot.main(['-O', region, '-p',
                        f'{os.path.join(tmp, "multires.cool")}::10000', '-I',
                        os.path.join(tmp, 'combined.bedpe'), '-C', '21',
                        '-S', str(PLOT_REGION[0]),
                        '-E', str(PLOT_REGION[1])])
    t_plot = time.perf_counter() - t0
    with open(region, 'rb') as f:
        head = f.read(8)
    if rc != 0 or head != b'\x89PNG\r\n\x1a\n':
        raise AssertionError(f'[10c] peak-plot exited {rc}')
    log(f'[10c] APA figure from the card and from the CPU: {len(a)} bytes '
        f'each, byte-identical (CPU draw {t_apa:.2f} s); peak-plot of chr21 '
        f'{PLOT_REGION[0]}-{PLOT_REGION[1]} at 10 kb with the combined loops '
        f'in {t_plot:.2f} s ({os.path.getsize(region)} bytes)')
    return dict(apa_png_bytes=len(a), apa_cpu_s=t_apa, peakplot_s=t_plot,
                peakplot_png_bytes=os.path.getsize(region))


def figures(device, tmp, counters):
    """Phase 10: the figures' path on the card, from phase 9c's files."""
    log(f'[10] the figures\' path; matplotlib on this host: '
        f'{HAS_MATPLOTLIB}')
    t0 = time.perf_counter()
    out = dict(matplotlib=HAS_MATPLOTLIB,
               apa=apa_genome(device, tmp, counters),
               multires=multires_check(device, tmp, counters))
    if HAS_MATPLOTLIB:
        out['plots'] = figures_check(tmp)
    else:
        log('[10c] matplotlib is not installed on this host: the figures '
            'were not drawn')
    out['wall_s'] = time.perf_counter() - t0
    log(f'[10] {out["wall_s"]:.1f} s')
    return out


MESH_TILES = 4   # phase 11's tiles on the one card


def caller_plan(cfg, caller):
    """(plan, p_list, thr, d_lo) of ``caller``'s path."""
    from hicpeaks_tpu_torch.core import engine, poolplan
    if caller == 'hiccups':
        return (tuple(poolplan.hiccups_pool_plan(cfg.pw, cfg.ww, cfg.maxww)),
                tuple(sorted(set(cfg.pw))), cfg.min_local_reads, min(cfg.ww))
    return (tuple(poolplan.bhfdr_pool_plan(cfg.pw, cfg.ww, cfg.maxww)),
            (cfg.pw,), engine._BHFDR_THR, cfg.ww)


def single_front(bands, cfg, caller, device):
    """One device's sheets, pass A, the host replay of the freeze gate and
    pass B for ``caller`` ('hiccups' or 'bhfdr'): the inputs phase 11
    holds the tiles against."""
    import torch
    from hicpeaks_tpu_torch.core import engine, poolplan
    from hicpeaks_tpu_torch.ops import cuda_scan, score
    plan, p_list, thr, d_lo = caller_plan(cfg, caller)
    d_hi = cfg.maxapart // bands.res
    total = bands.candidate_total(d_lo, d_hi)
    ops = engine.bands_to_device(bands, device)
    raw, cband, eband, Bprod, gap_drop, cand = score.build_sheets(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        bands.ww_min, bands.L, d_lo, d_hi, d_lo)
    counts = cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr)
    if caller == 'hiccups':
        decision = poolplan.emulate_freeze_hiccups(
            plan, counts.cpu().numpy(), total, cfg.ww)
    else:
        decision = poolplan.emulate_freeze_bhfdr(plan, counts.cpu().numpy(),
                                                 total)
    allowed = torch.tensor(decision.allowed, dtype=torch.bool, device=device)
    caps = cuda_scan.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                 p_list, thr)
    return dict(raw=raw, cband=cband, eband=eband, cand=cand, Bprod=Bprod,
                IR=ops['IR'], L=bands.L, plan=plan, p_list=p_list, thr=thr,
                counts=counts, allowed=allowed, caps=caps)


def hiccups_observed(f, cfg):
    """E, O, lambda chunks and their edge suspects of every background of
    the batched pyHICCUPS scorer (each (p, w) pair's K, then its Y), on
    one device's front ``f``."""
    import torch
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.ops import score
    pairs = list(zip(cfg.pw, cfg.ww))
    BSV = torch.stack([f['caps'][p][0] for p, _ in pairs]
                      + [f['caps'][p][2] for p, _ in pairs])
    BEV = torch.stack([f['caps'][p][1] for p, _ in pairs]
                      + [f['caps'][p][3] for p, _ in pairs])
    wis = torch.tensor([w for _, w in pairs] * 2, dtype=torch.int32,
                       device=f['raw'].device)[:, None, None]
    E, O, _, _, scored, _ = score.expected_observed(
        f['raw'], f['cband'], f['IR'], f['Bprod'], BSV, BEV, wis, f['cand'],
        f['L'])
    cid, _, valid = score.lambda_chunks(E, scored)
    sus = score.lambda_suspects(E, scored, engine._chunk_margin(f['plan']))
    return O, cid, valid, sus


def suspect_count(f, cfg):
    """(pixels, lambda chunks) of the batched pyHICCUPS scorer's edge
    suspects on one device's front ``f``: the pixels that the float64
    completion moves to their float64 chunk, on one device and on the
    tiles alike (JAX's mesh route sets none aside)."""
    _, cid, _, sus = hiccups_observed(f, cfg)
    return int(sus.sum()), len(cid[sus].unique())


def mesh_kernel_checks(bands, cfg, caller, mesh, device):
    """Phase 11a's kernel checks: the tiles' summed pass-A counts equal
    one device's, their stitched pass-B captures are bit-equal to its
    captures, and (pyHICCUPS) the tiles' summed histogram equals its
    histogram in rows >= 1.  Returns one device's front."""
    import torch
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.ops import cuda_hist, score
    from hicpeaks_tpu_torch.parallel import tiles
    f = single_front(bands, cfg, caller, device)
    sh = {k: tiles.shard_band(f[k], mesh)
          for k in ('raw', 'cband', 'eband', 'cand')}
    counts = tiles.scan_pass_a_sharded(sh['raw'], sh['cand'], f['plan'],
                                       f['p_list'], f['thr'], mesh)
    if not torch.equal(counts, f['counts']):
        raise AssertionError(f'[11a] {caller}: the tiles\' pass-A counts '
                             f'{counts.tolist()} != {f["counts"].tolist()}')
    outs = tiles.scan_pass_b_sharded(
        sh['raw'], sh['cband'], sh['eband'], sh['cand'], f['allowed'],
        f['plan'], f['p_list'], f['thr'], mesh)
    Lp = f['raw'].shape[1]
    for p in f['p_list']:
        for t, name in enumerate(('KS', 'KE', 'YS', 'YE')):
            got = torch.cat([o[p][t] for o in outs], -1)[:, :Lp]
            if not torch.equal(got, f['caps'][p][t]):
                raise AssertionError(f'[11a] {caller}: stitched capture p={p} '
                                     f'{name} differs by up to '
                                     f'{max_abs(got, f["caps"][p][t])}')
    del outs
    msg = (f'pass-A counts equal ({int(counts.sum())} frozen), pass-B '
           f'captures bit-equal')
    if caller == 'hiccups':
        O, cid, valid, _ = hiccups_observed(f, cfg)
        o_cap = engine._bh_plan(bands.max_count)
        S, C = score.chunk_rows(o_cap, cfg.siglevel), o_cap + 1
        oc, cid0 = score.chunk_pack(O, cid, valid, S, C)
        want = cuda_hist.chunk_hist(oc, cid0, S, C)
        got = tiles.chunk_hist_sharded(
            tiles.shard_band(O, mesh), tiles.shard_band(cid, mesh),
            tiles.shard_band(valid, mesh), S, C, mesh)
        if not torch.equal(got[1:], want[1:]):
            raise AssertionError(f'[11a] the tiles\' histogram differs in '
                                 f'rows >= 1 by up to '
                                 f'{max_abs(got[1:], want[1:])}')
        cell = 'equal' if torch.equal(got, want) else 'differs'
        msg += (f', histogram equal in rows >= 1 ({int(want[1:].sum())} '
                f'pixels; cell (0, 0) {cell})')
    log(f'[11a] {caller} on {mesh.size} tiles against one device: {msg}')
    return f


def mesh_tiles(device, counters, bench, chr1_h, chr1_b):
    """Phase 11a and 11b: four tiles of one single-process mesh on the
    card.  ``bench`` = (bands, hcfg, bcfg, oracle pyHICCUPS table, oracle
    pyBHFDR table) of phases 3 and 5; ``chr1_h``/``chr1_b`` = (bands, cfg,
    n_cand) of phases 4 and 6."""
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.parallel.mesh import make_tile_mesh
    mesh = make_tile_mesh(devices=[device] * MESH_TILES)
    out = {}
    # the tiles complete on the host and score with the eager chain
    want = dict(scan_pass_a=MESH_TILES, scan_pass_b=MESH_TILES,
                window_stats64=0, finish64=0, score_observe=0, score_keep=0,
                score_gather=0, score_prod=0)

    def held(launches, hist):
        expect = dict(want, chunk_hist=hist)
        if launches != expect:
            raise AssertionError(f'[11a] mesh launches {launches}, want '
                                 f'{expect}')

    # the bench shape against the float64 oracle (phases 3 and 5's bar)
    bands, hcfg, bcfg, want_h, want_b = bench
    table, _, launches = run_counted(
        counters, lambda: engine.hiccups_chrom(bands, hcfg, mesh=mesh))
    held(launches, MESH_TILES)
    rel_h = compare_to_oracle(table, want_h)
    btable, _, launches = run_counted(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, mesh=mesh))
    held(launches, 0)
    rel_b = compare_to_oracle(btable, want_b)
    if bhfdr_bedpe_lines(btable) != bhfdr_bedpe_lines(want_b):
        raise AssertionError('[11a] bench pyBHFDR mesh bedpe lines differ '
                             'from the oracle\'s')
    log(f'[11a] bench shape on {mesh.size} tiles: pyHICCUPS {len(table)} '
        f'peaks, max rel {rel_h:.3g}; pyBHFDR {len(btable)} peaks, max rel '
        f'{rel_b:.3g}, sorted bedpe lines identical; against the oracle')

    # chr1: kernels, launches, walls, tables against one device's
    bands, cfg, n_cand = chr1_h
    f = mesh_kernel_checks(bands, cfg, 'hiccups', mesh, device)
    n_sus, n_chunks = suspect_count(f, cfg)
    del f
    _, single = steady_walls(
        counters, lambda: engine.hiccups_chrom(bands, cfg, device=device),
        n_cand, '[11a] chr1 pyHICCUPS, one device')
    launches, meshed = steady_walls(
        counters, lambda: engine.hiccups_chrom(bands, cfg, mesh=mesh),
        n_cand, f'[11a] chr1 pyHICCUPS, {mesh.size} tiles')
    held(launches, MESH_TILES)
    out['hiccups_launches'] = launches
    rel = compare_to_oracle(meshed, single)
    log(f'[11a] chr1 pyHICCUPS: {len(meshed)} peaks, loci and geometry '
        f'identical to one device\'s, max rel stat diff {rel:.3g}; {n_sus} '
        f'edge suspects in {n_chunks} lambda chunks, set aside and '
        'corrected on the tiles as on one device')
    out.update(hiccups_suspects=n_sus, hiccups_suspect_chunks=n_chunks,
               hiccups_max_rel=rel)

    # 11b: IR from the tiles
    dev_ir = engine.hiccups_chrom(bands, cfg, mesh=mesh, ir_backend='device')
    rel_ir = compare_to_oracle(dev_ir, meshed, rtol=float('inf'))
    log(f'[11b] ir_backend=\'device\' on {mesh.size} tiles: loci and '
        f'geometry identical to the host IR\'s table, max rel stat diff '
        f'{rel_ir:.3g}')
    out['device_ir_max_rel'] = rel_ir

    bands, bcfg, n_cand = chr1_b
    mesh_kernel_checks(bands, bcfg, 'bhfdr', mesh, device)
    _, single = steady_walls(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, device=device),
        n_cand, '[11a] chr1 pyBHFDR, one device')
    launches, meshed = steady_walls(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, mesh=mesh),
        n_cand, f'[11a] chr1 pyBHFDR, {mesh.size} tiles')
    held(launches, 0)
    out['bhfdr_launches'] = launches
    if meshed != single or list(meshed) != list(single):
        raise AssertionError('[11a] chr1 pyBHFDR mesh table differs from '
                             'one device\'s')
    log(f'[11a] chr1 pyBHFDR: {len(meshed)} peaks, the mesh table == one '
        'device\'s, in the same order')
    return out


def _payload(tables):
    return {c: [[list(k), list(map(float, v))] for k, v in t.items()]
            for c, t in tables.items()}


def _unpayload(payload):
    return {c: {tuple(k): tuple(v) for k, v in t} for c, t in
            payload.items()}


def mesh_worker(mode, uri, out_path, device):
    """One process of phase 11c ('api') or 11d ('global'), started by
    :func:`run_group` with the HICPEAKS_* variables set, on its own
    ``device`` (a bare 'cuda' is the process's card)."""
    sys.path.insert(0, REPO)
    import numpy as np
    from hicpeaks_tpu_torch import api
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.ops import (cuda_complete, cuda_hist, cuda_scan,
                                        cuda_score)
    from hicpeaks_tpu_torch.parallel import launch, multihost
    counters = (cuda_scan.scan_pass_a, cuda_scan.scan_pass_b,
                cuda_hist.chunk_hist, cuda_complete.window_stats64,
                cuda_complete.finish64, cuda_score.score_observe,
                cuda_score.score_keep, cuda_score.score_gather,
                cuda_score.score_prod)
    if not launch.maybe_initialize_distributed():
        raise RuntimeError('mesh worker: HICPEAKS_* variables not set')
    _, rank = launch.world()
    device = launch.process_device(device)
    out = dict(rank=rank, device=str(device),
               transport=launch.device_transport()[0])
    if mode == 'api':
        tables, wall, launches = run_counted(
            counters, lambda: api.call_bhfdr(uri, BHFDRConfig(),
                                             device=device))
        out.update(wall_s=wall, launches=launches, tables=_payload(tables))
    else:
        mesh = multihost.global_tile_mesh([device, device])
        clr = CoolerLite(uri)
        reads = []
        by_range = CoolerLite.pixels_for_bin1_range

        def recording(self, chrom, c0, c1):
            reads.append((int(c0), int(c1)))
            return by_range(self, chrom, c0, c1)

        CoolerLite.pixels_for_bin1_range = recording
        CoolerLite.pixels_for_chrom = None       # a whole read would raise
        for kind, cfg, call in (
                ('bhfdr', BHFDRConfig(), engine.bhfdr_chrom),
                ('hiccups', HiccupsConfig(), engine.hiccups_chrom)):
            t0 = time.perf_counter()
            bands = multihost.sharded_bands_from_cooler(
                clr, '1', cfg.maxapart, cfg.maxww, cfg.ww_min, mesh,
                dtype=np.float32)
            t_band = time.perf_counter() - t0
            table, wall, launches = run_counted(
                counters, lambda: call(bands, cfg, mesh=mesh))
            t0 = time.perf_counter()
            call(bands, cfg, mesh=mesh)
            steady = time.perf_counter() - t0
            out[kind] = dict(
                tables=_payload({'1': table}), band_s=t_band, wall_s=wall,
                steady_s=steady, launches=launches,
                IR=np.asarray(bands.IR, np.float64).tolist(),
                spans=sorted(bands.raw_spans))
        out['reads'] = reads
    launch.shutdown_distributed()
    with open(out_path, 'w') as f:
        json.dump(out, f)
    return 0


def run_group(argv_of, tag, n=2):
    """``n`` processes of one torch.distributed group on this host, the
    argv of process r ``argv_of(r)``; raises unless every one exits 0;
    returns each one's wall in seconds."""
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    procs, t0 = [], time.perf_counter()
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=REPO,
                   HICPEAKS_COORDINATOR=f'localhost:{port}',
                   HICPEAKS_NUM_PROCESSES=str(n), HICPEAKS_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(argv_of(r), cwd=REPO, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    walls, logs = [None] * n, [None] * n
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=600)
            walls[r] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f'{tag}: process {r} exited {p.returncode}:'
                                 f'\n{logs[r][1][-3000:]}')
    return walls


def mesh_processes(device, tmp, files, counters):
    """Phase 11c and 11d: two processes sharing the card on gloo, on phase
    9b's chr1 cooler and phase 9c's genome cooler (``files``: the keep
    dict of :func:`cli_check` and :func:`genome_check`)."""
    import numpy as np
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler
    me = os.path.abspath(__file__)
    out = {}

    # 11c: chromosome data-parallelism, the API then the CLI
    uri = files['genome_uri']
    walls = run_group(lambda r: [sys.executable, me, '--mesh-worker', 'api',
                                 uri, os.path.join(tmp, f'api.{r}.json'),
                                 device], '[11c] call_bhfdr')
    single = files['genome_results']
    got = [json.load(open(os.path.join(tmp, f'api.{r}.json')))
           for r in range(2)]
    for g in got:
        t = _unpayload(g['tables'])
        if t != single or list(t) != list(single) or any(
                list(t[c]) != list(single[c]) for c in single):
            raise AssertionError(f'[11c] process {g["rank"]}\'s genome table '
                                 'differs from the single process\'s')
    log(f'[11c] call_bhfdr in 2 processes on {got[0]["device"]} '
        f'({got[0]["transport"]}): each returns the genome table of phase '
        f'9c, in its order; calls {got[0]["wall_s"]:.2f} / '
        f'{got[1]["wall_s"]:.2f} s, processes {walls[0]:.1f} / '
        f'{walls[1]:.1f} s; launches {got[0]["launches"]} / '
        f'{got[1]["launches"]}')
    out['api'] = dict(call_s=[g['wall_s'] for g in got], process_s=walls,
                      launches=[g['launches'] for g in got])
    walls = run_group(
        lambda r: [sys.executable, '-m', 'hicpeaks_tpu_torch.cli.peakcall',
                   'pyBHFDR', '-O', os.path.join(tmp, f'cli.{r}.bedpe'),
                   '-p', uri, '--device', device, '--logFile',
                   os.path.join(tmp, f'cli.{r}.log')], '[11c] pyBHFDR CLI')
    want = open(files['genome_bedpe'], 'rb').read()
    for r in range(2):
        if open(os.path.join(tmp, f'cli.{r}.bedpe'), 'rb').read() != want:
            raise AssertionError(f'[11c] process {r}\'s bedpe differs from '
                                 'the single process\'s')
    log(f'[11c] the pyBHFDR CLI in 2 processes: both bedpe files '
        f'byte-identical to phase 9c\'s ({len(want.splitlines())} lines); '
        f'processes {walls[0]:.1f} / {walls[1]:.1f} s')
    out['cli_process_s'] = walls

    # 11d: a global mesh, 2 processes x 2 tiles, per-process ingestion
    uri = files['chr1_uri']
    walls = run_group(lambda r: [sys.executable, me, '--mesh-worker',
                                 'global', uri,
                                 os.path.join(tmp, f'global.{r}.json'),
                                 device], '[11d] global mesh')
    got = [json.load(open(os.path.join(tmp, f'global.{r}.json')))
           for r in range(2)]
    clr = CoolerLite(uri)
    spans = [sorted(tuple(s) for s in g['bhfdr']['spans']) for g in got]
    cols = sorted(spans[0] + spans[1])
    if cols[0][0] != 0 or any(a1 != b0 for (_, b0), (a1, _) in
                              zip(cols, cols[1:])):
        raise AssertionError(f'[11d] the processes\' spans {spans} do not '
                             'tile the chromosome')
    for g, own in zip(got, spans):
        if not g['reads'] or not all(any(a <= c0 and c1 <= b
                                         for a, b in own)
                                     for c0, c1 in g['reads']):
            raise AssertionError(f'[11d] process {g["rank"]} read '
                                 f'{g["reads"]} outside its spans {own}')
    out['global'] = {}
    for kind, cfg, call in (('bhfdr', BHFDRConfig(), engine.bhfdr_chrom),
                            ('hiccups', HiccupsConfig(),
                             engine.hiccups_chrom)):
        bands = bands_from_cooler(clr, '1', cfg.maxapart, cfg.maxww,
                                  cfg.ww_min, keep_sparse=False)
        for g in got:
            if not np.array_equal(np.asarray(g[kind]['IR'], np.float32),
                                  bands.IR, equal_nan=True):
                raise AssertionError(f'[11d] {kind}: process {g["rank"]}\'s '
                                     'IR is not bands_from_cooler\'s')
        single = call(bands, cfg, device=device)
        tables = [_unpayload(g[kind]['tables'])['1'] for g in got]
        if tables[0] != tables[1] or list(tables[0]) != list(tables[1]):
            raise AssertionError(f'[11d] {kind}: the processes\' tables '
                                 'differ')
        if kind == 'bhfdr':
            if tables[0] != single or list(tables[0]) != list(single):
                raise AssertionError('[11d] pyBHFDR global-mesh table '
                                     'differs from one device\'s')
            note = 'the table == one device\'s'
        else:
            rel = compare_to_oracle(tables[0], single)
            note = (f'loci and geometry identical to one device\'s, max rel '
                    f'stat diff {rel:.3g}')
        rec = [dict((k, g[kind][k]) for k in ('band_s', 'wall_s', 'steady_s',
                                              'launches')) for g in got]
        out['global'][kind] = rec
        log(f'[11d] {kind} on a global mesh of 2 processes x 2 tiles '
            f'({got[0]["transport"]}): IR bit-equal to bands_from_cooler\'s '
            f'on both, {len(tables[0])} peaks, {note}; per process: band '
            f'build {rec[0]["band_s"]:.2f} / {rec[1]["band_s"]:.2f} s, calls '
            f'{rec[0]["wall_s"]:.2f} / {rec[1]["wall_s"]:.2f} s, steady '
            f'{rec[0]["steady_s"]:.3f} / {rec[1]["steady_s"]:.3f} s, '
            f'launches {rec[0]["launches"]} / {rec[1]["launches"]}')
    log(f'[11d] processes {walls[0]:.1f} / {walls[1]:.1f} s; spans '
        f'{spans[0]} | {spans[1]}')
    out['global_process_s'] = walls
    # the CLI's --mesh-devices 2 in a group: JAX's make_tile_mesh(2) over
    # the group's devices, a global mesh of one tile a process
    walls = run_group(
        lambda r: [sys.executable, '-m', 'hicpeaks_tpu_torch.cli.peakcall',
                   'pyBHFDR', '-O', os.path.join(tmp, f'gcli.{r}.bedpe'),
                   '-p', uri, '--pw', '2', '--ww', '5', '--device', device,
                   '--mesh-devices', '2', '--logFile',
                   os.path.join(tmp, f'gcli.{r}.log')],
        '[11d] pyBHFDR CLI --mesh-devices 2')
    want = open(files['chr1_bhfdr_bedpe'], 'rb').read()
    for r in range(2):
        if open(os.path.join(tmp, f'gcli.{r}.bedpe'), 'rb').read() != want:
            raise AssertionError(f'[11d] process {r}\'s --mesh-devices 2 '
                                 'bedpe differs from phase 9b\'s')
        if 'global 2-tile mesh across 2 processes' not in open(
                os.path.join(tmp, f'gcli.{r}.log')).read():
            raise AssertionError(f'[11d] process {r}\'s CLI did not take '
                                 'the global mesh')
    log(f'[11d] the pyBHFDR CLI with --mesh-devices 2 in 2 processes: a '
        f'global mesh of one tile a process, both bedpe files '
        f'byte-identical to phase 9b\'s ({len(want.splitlines())} lines); '
        f'processes {walls[0]:.1f} / {walls[1]:.1f} s')
    out['global_cli_process_s'] = walls
    return out


# phase 12: the hand-written kernels as a trace names them (kineto may print
# the demangled signature, so a name is matched as a substring), and the
# fused route's launches of each per chromosome call (PERF.md section 6)
TRACED_KERNELS = {'scan_pass_a': 'scan_pass_a_kernel',
                  'scan_pass_b': 'scan_pass_b_kernel',
                  'chunk_hist': 'chunk_hist_kernel',
                  'window_stats64': 'complete64_kernel',
                  'finish64': 'finish64_kernel',
                  'score_observe': 'score_observe_kernel',
                  'score_keep': 'score_keep_kernel',
                  'score_gather': 'score_gather_kernel'}
FUSED_LAUNCHES = {'pyHICCUPS': dict(scan_pass_a=1, scan_pass_b=1,
                                    chunk_hist=1, window_stats64=1,
                                    finish64=1, score_observe=1,
                                    score_keep=1, score_gather=1,
                                    score_prod=0),
                  'pyBHFDR': dict(scan_pass_a=1, scan_pass_b=1,
                                  chunk_hist=0, window_stats64=0,
                                  finish64=0, score_observe=0,
                                  score_keep=0, score_gather=0,
                                  score_prod=0)}


def fused_launches(tool, launches, calls=1):
    """The launches of ``calls`` chromosome calls of ``tool`` on the fused
    route: FUSED_LAUNCHES's, and on pyHICCUPS one score_gather more for
    each postcheck's gather that ``launches`` counted (score_prod; none on
    pyBHFDR)."""
    want = {k: n * calls for k, n in FUSED_LAUNCHES[tool].items()}
    if tool == 'pyHICCUPS':
        want['score_prod'] = launches['score_prod']
        want['score_gather'] += launches['score_prod']
    return want
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
# phase 14: the kernel records' launch keys of the routes whose batched
# pyHICCUPS scorer takes the fused kernels, once a chromosome call (the
# three resolutions of 10b too, and 13's staged chromosomes, one each)
FUSED_SCORER_ROUTES = ('launches', 'bench_launches', 'deep_launches',
                       'a_hiccups_validate_launches',
                       'pipeline_hiccups_launches', 'trace_hiccups_launches')


def score_launches(records):
    """Phase 14: the fused scorer's kernels launched once a chromosome
    call on every route of the batched pyHICCUPS scorer on one device and
    never elsewhere (pyBHFDR, the dense and segmented scorers,
    ``check=True``, the tiles, the genome's pyBHFDR calls), read from the
    kernel records' launch counts; the gather once more for each
    postcheck's gather (``score_prod``, never off those routes)."""
    by_name = {r['name']: r for r in records}
    chroms = by_name['scan_pass_a']['staging_hiccups_launches']
    prods = by_name['score_prod']
    for name in ('score_observe', 'score_keep', 'score_gather',
                 'score_prod'):
        got, want = {}, {}
        for k, v in by_name[name].items():
            if not k.endswith('launches'):
                continue
            got[k] = v
            fused = k in FUSED_SCORER_ROUTES or k.startswith('multires_')
            if fused or k == 'staging_hiccups_launches':
                calls = 1 if fused else chroms
                want[k] = {'score_gather': calls + prods[k],
                           'score_prod': v}.get(name, calls)
            else:
                want[k] = [0] * len(v) if isinstance(v, list) else 0
        if got != want:
            bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
            raise AssertionError(f'[14] {name} launches (got, want): {bad}')
        log(f'[14] {name}: launches a call {json.dumps(got)}')


def union_ms(spans):
    """Milliseconds covered by the union of (start, end) microsecond
    spans."""
    total, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def trace_summary(path):
    """What a Chrome trace of ``api._run``'s capture holds: the traced
    window (every complete event, host and device), the device's busy
    time (the union of its kernels, copies and memsets) and idle share,
    the kernels by name with their counts and total time, and each
    hand-written kernel's events."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    done = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    if not done:
        raise AssertionError(f'[12] {path} holds no complete event')
    spans = [(float(e['ts']), float(e['ts']) + float(e['dur']))
             for e in done]
    window_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    device = [(float(e['ts']), float(e['ts']) + float(e['dur']))
              for e in done if e.get('cat') in DEVICE_CATS]
    kernels = [e for e in done if e.get('cat') == 'kernel']
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e['name'], (0, 0.0))
        by_name[e['name']] = (n + 1, t + float(e['dur']) / 1e3)
    busy_ms = union_ms(device)
    first = min(done, key=lambda e: float(e['ts']))
    ours = {k: [float(e['dur']) / 1e3 for e in kernels if sub in e['name']]
            for k, sub in TRACED_KERNELS.items()}
    return dict(events=len(events), cpu_ops=sum(
                    e.get('cat') == 'cpu_op' for e in done),
                kernel_events=len(kernels), window_ms=window_ms,
                busy_ms=busy_ms, idle_share=1.0 - busy_ms / window_ms,
                device_span_ms=(max(b for _, b in device) -
                                min(a for a, _ in device)) / 1e3
                if device else 0.0,
                first_event=first['name'], first_thread=first.get('tid'),
                lead_ms=(min(a for a, _ in device) - float(first['ts'])) / 1e3
                if device else 0.0,
                top=sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5],
                ours=ours, file_mib=os.path.getsize(path) / 2 ** 20)


def trace_check(device, tmp, counters, uri, smi, kernel_ms=None):
    """Phase 12: ``api.call_hiccups`` and ``api.call_bhfdr`` on chr1 of the
    cooler at ``uri`` (phase 9b's), each called once to warm up and once
    with ``profile_dir``: one trace file, CUDA kernels in it, each
    hand-written kernel as many times as its launch counter gives and as
    the fused route launches it, and the table == the untraced one.
    ``kernel_ms`` ({tool: {kernel: CUDA-event ms}}, phases 4 and 6) is
    printed beside the traced durations."""
    from hicpeaks_tpu_torch import api
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    t_phase = time.perf_counter()
    out = {}
    for tool, call, cfg in (('pyHICCUPS', api.call_hiccups, HiccupsConfig()),
                            ('pyBHFDR', api.call_bhfdr, BHFDRConfig())):
        # JAX's call form: no device, which is the card
        want, t_plain, jax_launches = run_counted(
            counters, lambda: call(uri, cfg, chroms=('1',)))
        tdir = os.path.join(tmp, f'trace.{tool}', 'new')
        table, wall, launches = run_counted(
            counters, lambda: call(uri, cfg, chroms=('1',), device=device,
                                   profile_dir=tdir))
        files = os.listdir(tdir)
        if len(files) != 1 or not files[0].endswith('.pt.trace.json'):
            raise AssertionError(f'[12] {tool}: trace files {files}')
        r = trace_summary(os.path.join(tdir, files[0]))
        traced = {k: len(v) for k, v in r['ours'].items()}
        if r['kernel_events'] < 1:
            raise AssertionError(f'[12] {tool}: no CUDA kernel in the trace')
        fused = fused_launches(tool, launches)
        if traced != {k: launches[k] for k in traced} or launches != fused:
            raise AssertionError(
                f'[12] {tool}: kernels in the trace {traced}, launch '
                f'counters {launches}, fused route {fused}')
        if table != want or jax_launches != launches:
            raise AssertionError(
                f'[12] {tool}: the traced table (device={device!r}) '
                f'differs from JAX\'s call form (no device), or its '
                f'launches {launches} from {jax_launches}')
        log(f'[12] {tool} chr1 traced ({files[0]}, {r["file_mib"]:.1f} MiB, '
            f'{r["events"]} events, {r["cpu_ops"]} host ops): call '
            f'{wall:.3f} s (untraced JAX form, warming up: {t_plain:.3f} s); '
            f'window {r["window_ms"]:.3f} ms, device busy '
            f'{r["busy_ms"]:.3f} ms (kernels, copies, memsets), idle '
            f'{r["idle_share"]:.1%}; first to last device event '
            f'{r["device_span_ms"]:.3f} ms, the first {r["lead_ms"]:.3f} ms '
            f'after the window opens ({r["first_event"][:40]!r} on thread '
            f'{r["first_thread"]}); {r["kernel_events"]} kernels; '
            f'{sum(len(t) for t in table.values())} peaks == untraced '
            'JAX form; '
            f'{smi}')
        log('[12]   top kernels by device time: ' + '; '.join(
            f'{n[:60]} x{c} {t:.3f} ms' for n, (c, t) in r['top']))
        for k, durs in r['ours'].items():
            if not durs:
                continue
            ev = (kernel_ms or {}).get(tool, {}).get(k)
            log(f'[12]   {k}: traced x{len(durs)}, {sum(durs):.4f} ms; '
                'CUDA events ' + (f'{ev:.4f} ms' if ev is not None
                                  else 'not timed in this run'))
        out[tool] = dict(r, wall_s=wall, plain_wall_s=t_plain,
                         launches=launches, traced=traced,
                         jax_form_launches=jax_launches,
                         peaks=sum(len(t) for t in table.values()),
                         top=[[n, c, t] for n, (c, t) in r['top']])
    out['phase_s'] = time.perf_counter() - t_phase
    log(f'[12] phase 12 in {out["phase_s"]:.2f} s')
    return out


# phase 13: the staged host-to-device copies as a trace names them
PINNED_COPY = 'Memcpy HtoD (Pinned -> Device)'
PAGEABLE_COPY = 'Memcpy HtoD (Pageable -> Device)'


def staging_summary(path, labels, slab_bytes):
    """What a Chrome trace of ``api._run`` shows of the staging, for each
    chromosome of ``labels`` in call order: its call's span (the
    ``Chrom:<label>`` mark) and the kernels inside it, and its slab's
    host-to-device copy, the copy of ``slab_bytes[label]`` bytes, matched
    from the last chromosome back (each chromosome's copies go out in
    call order on one stream; the first chromosome's may fall before the
    capture starts).  Per chromosome: the copy's name, stream, traced ms
    and bytes, its overlap with the previous chromosome's kernels, and
    the consumer's wait from its call's start to its first kernel."""
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    marks = {e['name'][len('Chrom:'):]: e for e in events
             if e.get('cat') == 'user_annotation'
             and e['name'].startswith('Chrom:')}
    kernels = sorted((e for e in events if e.get('cat') == 'kernel'),
                     key=lambda e: float(e['ts']))
    copies = sorted((e for e in events if e.get('cat') == 'gpu_memcpy'
                     and 'HtoD' in e['name']), key=lambda e: float(e['ts']))
    if set(marks) != set(labels):
        raise AssertionError(f'[13] {path}: marks {sorted(marks)}, called '
                             f'{labels}')
    if copies and 'bytes' not in copies[0].get('args', {}):
        raise AssertionError(f'[13] a copy event without bytes: {copies[0]}')
    slab, before = {}, len(copies)
    for label in reversed(labels):
        for j in range(before - 1, -1, -1):
            if int(copies[j]['args']['bytes']) == slab_bytes[label]:
                slab[label], before = copies[j], j
                break
    out, prev = [], None
    for label in labels:
        m = marks[label]
        s, e = float(m['ts']), float(m['ts']) + float(m['dur'])
        mine = [(float(k['ts']), float(k['ts']) + float(k['dur']),
                 k['args'].get('stream')) for k in kernels
                if s <= float(k['ts']) <= e]
        if not mine:
            raise AssertionError(f'[13] chromosome {label}: no kernel in its '
                                 'call')
        rec = dict(chrom=label, bytes=slab_bytes[label],
                   wait_ms=(mine[0][0] - s) / 1e3, call_ms=(e - s) / 1e3,
                   kernel_streams=sorted({k[2] for k in mine}))
        c = slab.get(label)
        if c is not None:
            a, b = float(c['ts']), float(c['ts']) + float(c['dur'])
            rec.update(copy=c['name'], copy_stream=c['args'].get('stream'),
                       copy_ms=float(c['dur']) / 1e3,
                       copy_gb_s=slab_bytes[label] / float(c['dur']) / 1e3,
                       lead_ms=(s - b) / 1e3)
            if prev is not None:
                rec['overlap_ms'] = union_ms(
                    [(max(a, x), min(b, y)) for x, y, _ in prev
                     if x < b and y > a])
                rec['overlapped'] = rec['overlap_ms'] > 0
        out.append(rec)
        prev = mine
    pageable = [c for c in copies if c['name'] == PAGEABLE_COPY
                and int(c['args']['bytes']) in slab_bytes.values()]
    return out, len(pageable)


def staging_check(device, tmp, counters, uri, smi, genome_tables):
    """Phase 13: the prefetch thread's staging on 9c's genome cooler at
    ``uri``: ``api.call_hiccups`` on chromosomes 1-3 and
    ``api.call_bhfdr`` on every chromosome, on the card with
    ``profile_dir``.  Every chromosome called is staged once, and each
    table == the engine's on ``bands_from_cooler``'s unstaged bands
    (pyBHFDR's also == ``genome_tables``, 9c's); in the trace each
    chromosome's slab after the first goes out as a pinned copy on a
    stream none of its kernels runs on, and no slab as a pageable copy.
    Then ``call_hiccups`` again with the staging switched off, the path
    before staging: each slab a pageable copy on the kernels' stream,
    the same tables.  Prints per chromosome the copy's ms and bytes, how
    long it overlapped the previous chromosome's kernels, and the
    consumer's wait from its call's start to its first kernel; and each
    call's peak device memory."""
    import numpy as np
    import torch
    from hicpeaks_tpu_torch import api
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler
    t_phase = time.perf_counter()
    clr = CoolerLite(uri)
    names = list(clr.chromnames)
    real_stage = engine.stage_chrom_arrays
    out = {}
    for tag, tool, staging, keys in (('pyHICCUPS', 'pyHICCUPS', True,
                                      names[:3]),
                                     ('pyHICCUPS_unstaged', 'pyHICCUPS',
                                      False, names[:3]),
                                     ('pyBHFDR', 'pyBHFDR', True, names)):
        call, cfg, fn = (
            (api.call_hiccups, HiccupsConfig(), engine.hiccups_chrom)
            if tool == 'pyHICCUPS' else
            (api.call_bhfdr, BHFDRConfig(), engine.bhfdr_chrom))
        labels = [k.lstrip('chr') for k in keys]
        tdir = os.path.join(tmp, f'staging.{tag}')
        staged = real_stage.staged
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if not staging:
            engine.stage_chrom_arrays = lambda bands, *, device=None: None
        try:
            tables, wall, launches = run_counted(
                counters, lambda: call(uri, cfg, chroms=tuple(labels),
                                       device=device, profile_dir=tdir))
        finally:
            engine.stage_chrom_arrays = real_stage
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        staged = real_stage.staged - staged
        want_launches = fused_launches(tool, launches, len(labels))
        if staged != len(labels) * staging or list(tables) != labels or \
                launches != want_launches:
            raise AssertionError(
                f'[13] {tag}: {staged} chromosomes staged, tables '
                f'{list(tables)}, launches {launches}; called {labels}, '
                f'launches {want_launches}')
        slab_bytes, t0 = {}, time.perf_counter()
        for key, label in zip(keys, labels):
            bands = bands_from_cooler(clr, key, cfg.maxapart, cfg.maxww,
                                      cfg.ww_min, dtype=np.float32,
                                      weight_name=cfg.clr_weight_name,
                                      keep_sparse=False)
            slab_bytes[label] = bands.raw.nbytes
            want = (fn(bands, cfg, device=device) if staging
                    else out[tool]['tables'][label])
            if want != tables[label]:
                raise AssertionError(f'[13] {tag} chromosome {label}: the '
                                     'table differs from the unstaged '
                                     'engine\'s')
        t_ref = time.perf_counter() - t0
        if tool == 'pyBHFDR' and tables != genome_tables:
            raise AssertionError('[13] pyBHFDR: the staged genome tables '
                                 'differ from phase 9c\'s')
        files = os.listdir(tdir)
        if len(files) != 1:
            raise AssertionError(f'[13] {tag}: trace files {files}')
        chroms, n_pageable = staging_summary(os.path.join(tdir, files[0]),
                                             labels, slab_bytes)
        if staging:
            bad = [r['chrom'] for r in chroms[1:]
                   if r.get('copy') != PINNED_COPY
                   or r['copy_stream'] in r['kernel_streams']]
            bad += ['pageable'] * n_pageable
        else:
            bad = [r['chrom'] for r in chroms
                   if r.get('copy') != PAGEABLE_COPY
                   or r['copy_stream'] not in r['kernel_streams']]
        if bad:
            raise AssertionError(
                f'[13] {tag}: chromosomes {bad} without a '
                + ('pinned slab copy on a stream of its own, or a pageable '
                   'slab copy' if staging else
                   'pageable slab copy on the kernels\' stream')
                + f': {chroms}')
        for r in chroms:
            log(f'[13] {tag} chr{r["chrom"]}: slab {r["bytes"]} B; ' + (
                f'{r["copy"][13:-1]} copy {r["copy_ms"]:.4f} ms '
                f'({r["copy_gb_s"]:.2f} GB/s) on stream {r["copy_stream"]},'
                f' ending {-r["lead_ms"]:+.3f} ms from the call\'s start'
                + (f', over the previous kernels {r["overlap_ms"]:.4f} ms'
                   if 'overlap_ms' in r else '')
                if 'copy_ms' in r else 'copy before the capture')
                + f'; kernels on {r["kernel_streams"]}; call '
                f'{r["call_ms"]:.3f} ms, wait to its first kernel '
                f'{r["wait_ms"]:.3f} ms')
        n_over = sum(r.get('overlapped', False) for r in chroms)
        log(f'[13] {tag}: {len(labels)} chromosomes called, {staged} '
            'staged, tables == '
            + ('the unstaged engine\'s' if staging else 'the staged call\'s')
            + (' and phase 9c\'s' if tool == 'pyBHFDR' else '')
            + f'; {n_over} of {len(chroms) - 1} later copies overlapped the '
            f'previous kernels; call {wall:.2f} s (traced), '
            + (f'unstaged builds and calls {t_ref:.2f} s; ' if staging
               else '')
            + f'peak device memory {peak_gib:.3f} GiB; launches '
            f'{launches}; {smi}')
        out[tag] = dict(chroms=chroms, staged=staged, wall_s=wall,
                        peak_gib=peak_gib, launches=launches,
                        overlapped=n_over, tables=tables,
                        **({'unstaged_s': t_ref} if staging else {}))
    for r in out.values():
        del r['tables']
    out['phase_s'] = time.perf_counter() - t_phase
    out['card'] = smi
    log(f'[13] phase 13 in {out["phase_s"]:.2f} s')
    return out


def user_pipeline(device, counters, multi=True, trace=None):
    """Phase 9: the user pipeline on the card, every cooler read and
    written through the port's h5lite (the host has no h5py): (a) TXT ->
    toCooler, (b) both CLIs from a cooler, (c) a genome; then phase 10,
    the figures' path on (c)'s files, with ``multi`` phase 11c and 11d on
    (b)'s and (c)'s, and with ``trace`` (:func:`trace_check`'s ``smi``
    and ``kernel_ms``) phase 12 on (b)'s and phase 13 on (c)'s.  Its files
    live under build/smoke/ and are removed afterwards."""
    import shutil
    tmp = os.path.join(REPO, 'build', 'smoke')
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    files = {}
    try:
        log('[9] the user pipeline: TXT -> toCooler -> CLIs -> bedpe')
        out = dict(ingest=ingest_check(device, tmp),
                   clis=cli_check(device, tmp, counters, keep=files),
                   genome=genome_check(device, tmp, counters, keep=files))
        log(json.dumps({'user_pipeline': out}))
        out['figures'] = figures(device, tmp, counters)
        log(json.dumps({'figures': out['figures']}))
        if multi:
            out['multi'] = mesh_processes(device, tmp, files, counters)
        if trace is not None:
            out['trace'] = trace_check(device, tmp, counters,
                                       files['chr1_uri'], **trace)
            log(json.dumps({'trace': out['trace']}))
            out['staging'] = staging_check(
                device, tmp, counters, files['genome_uri'], trace['smi'],
                files['genome_results'])
            log(json.dumps({'staging': out['staging']}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def multi_inputs():
    """Phase 11's inputs without phases 2-8: the bench shape's bands and
    the float64 oracle's tables (phases 3 and 5), and chr1's bands for
    both callers (phases 4 and 6)."""
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    num = 2_000_000 // RES + MAXWW + 1
    bench, w, bias_vec = synth_bands(
        8192, 2_000_000, seed=0, n_loops=200, span=min(200, num - MAXWW - 2),
        lane_pad=128)
    hcfg = HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW, maxapart=2_000_000)
    bcfg = BHFDRConfig(pw=PW[0], ww=WW[0], maxww=MAXWW, maxapart=2_000_000)
    dense = dense_inputs(bench, w, bias_vec, min(WW))
    want_h = oracle_table(dense, hcfg)
    want_b = oracle_table(dense, bcfg, caller='bhfdr')
    del dense
    out = dict(bench=(bench, hcfg, bcfg, want_h, want_b))
    for tag, cfg in (('chr1_h', HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW,
                                              maxapart=10_000_000)),
                     ('chr1_b', bcfg)):
        num = cfg.maxapart // RES + MAXWW + 1
        bands, _, _ = synth_bands(24900, cfg.maxapart, seed=42, n_loops=2000,
                                  span=num - MAXWW - 54, lane_pad=4096)
        d_lo = min(cfg.ww) if tag == 'chr1_h' else cfg.ww
        out[tag] = (bands, cfg,
                    bands.candidate_total(d_lo, cfg.maxapart // RES))
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--crossing-only', action='store_true',
                    help='run phases 1 and 8f alone')
    ap.add_argument('--pipeline-only', action='store_true',
                    help='run phases 1, 9 and 10 alone')
    ap.add_argument('--multi-only', action='store_true',
                    help='run phases 1 and 11 alone (11c and 11d on the '
                    'coolers of phases 9b and 9c, made first)')
    ap.add_argument('--trace-only', action='store_true',
                    help='run phases 1, 12 and 13 alone (12 on a chr1 '
                    'cooler written as phase 9b writes it, 13 on phase '
                    '9c\'s genome cut to chromosomes 1-3)')
    ap.add_argument('--mesh-worker', nargs=4,
                    metavar=('MODE', 'URI', 'OUT', 'DEVICE'),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_worker:
        return mesh_worker(*args.mesh_worker)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port does not run its '
              'kernels on the CPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.kernels import build
    from hicpeaks_tpu_torch.ops import (cuda_complete, cuda_hist, cuda_scan,
                                        cuda_score)

    device = 'cuda'
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f'[1] card: {smi}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.get_device_name(0)}')
    t0 = time.perf_counter()
    lib = build.load()
    log(f'[1] kernels built by nvcc for sm_90a from csrc/ in '
        f'{time.perf_counter() - t0:.2f} s (nvcc {lib.build_s:.2f} s): '
        f'{os.path.relpath(lib.path, REPO)}')
    for line in lib.build_log.splitlines():
        if 'ptxas info' in line and ('Used' in line or 'Compiling' in line):
            log(f'    {line.strip()}')
    counters = (cuda_scan.scan_pass_a, cuda_scan.scan_pass_b,
                cuda_hist.chunk_hist, cuda_complete.window_stats64,
                cuda_complete.finish64, cuda_score.score_observe,
                cuda_score.score_keep, cuda_score.score_gather,
                cuda_score.score_prod)
    if args.crossing_only or args.pipeline_only:
        if args.crossing_only:
            crossing(device, counters)
        if args.pipeline_only:
            user_pipeline(device, counters, multi=False)
        log(smi)
        return 0
    if args.trace_only:
        import shutil
        from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
        from hicpeaks_tpu_torch.ops import ice
        tmp = os.path.join(REPO, 'build', 'smoke')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            uri, _, t_write = chr1_cooler(tmp)
            ice.balance(CoolerLite(uri), device=device)
            log(f'[12] chr1 cooler written in {t_write:.2f} s and balanced '
                'on the card')
            log(json.dumps({'trace': trace_check(device, tmp, counters, uri,
                                                 smi)}))
            # 9c's genome cut to chromosomes 1-3
            files = {}
            genome_check(device, tmp, counters, keep=files,
                         sizes={c: HG38[c] for c in ('1', '2', '3')})
            log(json.dumps({'staging': staging_check(
                device, tmp, counters, files['genome_uri'], smi,
                files['genome_results'])}))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(smi)
        return 0
    if args.multi_only:
        import shutil
        t0 = time.perf_counter()
        ins = multi_inputs()
        log(f'[11] inputs synthesized in {time.perf_counter() - t0:.1f} s')
        mesh_out = mesh_tiles(device, counters, ins['bench'],
                              ins['chr1_h'], ins['chr1_b'])
        del ins
        tmp = os.path.join(REPO, 'build', 'smoke')
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        files = {}
        try:
            cli_check(device, tmp, counters, keep=files)
            genome_check(device, tmp, counters, keep=files)
            mesh_out.update(mesh_processes(device, tmp, files, counters))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        log(json.dumps({'multi': mesh_out}))
        log(smi)
        return 0

    # --- 2: kernels against twins at the bench shape ---
    maxapart = 2_000_000
    num = maxapart // RES + MAXWW + 1
    bench_bands, w, bias_vec = synth_bands(
        8192, maxapart, seed=0, n_loops=200, span=min(200, num - MAXWW - 2),
        lane_pad=128)
    bands = bench_bands
    cfg = HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW, maxapart=maxapart)
    n_cand = bands.candidate_total(min(WW), maxapart // RES)
    log(f'[2] bench shape: bands {bands.raw.shape}, {n_cand} candidates')
    bench = kernel_checks(bands, cfg, device, reps=10)
    # the multi-pair plan, whose drift re-adds read kept rings
    mcfg = HiccupsConfig(pw=(1, 2), ww=(3, 5), maxww=MAXWW,
                         maxapart=maxapart)
    log('[2] multi-pair plan pw=(1, 2), ww=(3, 5), maxww=10 at the bench '
        'shape')
    multi = kernel_checks(bands, mcfg, device, reps=3)

    # --- 3: the main path at the bench shape, against the oracle ---
    table, t_main, bench_launches = run_counted(
        counters, lambda: engine.hiccups_chrom(bands, cfg, device=device))
    log(f'[3] main path: hiccups_chrom in {t_main:.2f} s (first call), '
        f'{len(table)} peaks; kernel launches {bench_launches}')
    idle = [n for n, c in bench_launches.items()
            if c < 1 and n not in POSTCHECK_ONLY]
    if idle:
        raise AssertionError(f'main path did not launch {idle}')
    bench.update(completion_checks(
        lambda: engine.hiccups_chrom(bands, cfg, device=device), 10, '[3]'))
    bench.update(score_checks(
        lambda: engine.hiccups_chrom(bands, cfg, device=device), 10, '[3]'))
    t0 = time.perf_counter()
    # pyHICCUPS's min(ww) and pyBHFDR's ww are both 5: one set of dense
    # inputs serves phases 3 and 5
    dense = dense_inputs(bands, w, bias_vec, min(WW))
    want_h = want = oracle_table(dense, cfg)
    max_rel = compare_to_oracle(table, want)
    log(f'[3] oracle ({time.perf_counter() - t0:.1f} s): {len(want)} peaks; '
        f'loci identical, geometry identical, max rel stat diff {max_rel:.3g}')
    # JAX's call form: no device, which is the card
    jax_form, t_jax, jax_launches = run_counted(
        counters, lambda: engine.hiccups_chrom(bands, cfg))
    if jax_form != table or jax_launches != bench_launches:
        raise AssertionError(
            f'[3] hiccups_chrom(bands, cfg): {len(jax_form)} peaks, '
            f'launches {jax_launches}; device=\'cuda\': {len(table)} '
            f'peaks, launches {bench_launches}')
    defaults = {'engine_bench': dict(peaks=len(jax_form), equal=True,
                                     launches=jax_launches, wall_s=t_jax)}
    log(f'[3] JAX\'s call form hiccups_chrom(bands, cfg), no device: '
        f'{t_jax:.2f} s, {len(jax_form)} peaks == device=\'cuda\', '
        f'launches {jax_launches}')

    # --- 4: chr1 scale at the CLI default span ---
    maxapart = 10_000_000
    num = maxapart // RES + MAXWW + 1
    t0 = time.perf_counter()
    bands, _, _ = synth_bands(24900, maxapart, seed=42, n_loops=2000,
                              span=num - MAXWW - 54, lane_pad=4096)
    cfg = HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW, maxapart=maxapart)
    n_cand = bands.candidate_total(min(WW), maxapart // RES)
    log(f'[4] chr1 scale: bands {bands.raw.shape}, {n_cand} candidates '
        f'(synthesized in {time.perf_counter() - t0:.1f} s)')
    launches, chr1_table = steady_walls(
        counters, lambda: engine.hiccups_chrom(bands, cfg, device=device),
        n_cand, '[4] hiccups_chrom')
    chr1_run = (bands, cfg, chr1_table)
    mesh_h = (bands, cfg, n_cand)
    idle = [n for n, c in launches.items()
            if c < 1 and n not in POSTCHECK_ONLY]
    if idle:
        raise AssertionError(f'main path did not launch {idle}')
    streams_a = {}
    chr1 = kernel_checks(bands, cfg, device, reps=10, keep=streams_a)
    chr1.update(completion_checks(
        lambda: engine.hiccups_chrom(bands, cfg, device=device), 10, '[4]'))
    chr1.update(score_checks(
        lambda: engine.hiccups_chrom(bands, cfg, device=device), 10, '[4]'))
    # the upstream QuickStart's three pairs: B = 6 backgrounds
    qcfg = HiccupsConfig(pw=(1, 2, 4), ww=(3, 5, 7), maxww=MAXWW,
                         maxapart=maxapart)
    chr1_b6 = score_checks(
        lambda: engine.hiccups_chrom(bands, qcfg, device=device), 10,
        '[4] pw 1 2 4, ww 3 5 7:')

    # --- 5: pyBHFDR at the bench shape and the pyBHFDR CLI defaults ---
    bands, maxapart = bench_bands, 2_000_000
    bcfg = BHFDRConfig(pw=PW[0], ww=WW[0], maxww=MAXWW, maxapart=maxapart)
    n_cand = bands.candidate_total(bcfg.ww, maxapart // RES)
    log(f'[5] pyBHFDR at the bench shape: bands {bands.raw.shape}, {n_cand} '
        'candidates')
    bench_b = kernel_checks(bands, bcfg, device, reps=10, caller='bhfdr')
    btable, t_b, bench_b_launches = run_counted(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, device=device))
    log(f'[5] pyBHFDR path: bhfdr_chrom in {t_b:.2f} s (first call), '
        f'{len(btable)} peaks; kernel launches {bench_b_launches}')
    idle = [n for n in ('scan_pass_a', 'scan_pass_b')
            if bench_b_launches[n] < 1]
    if idle:
        raise AssertionError(f'pyBHFDR path did not launch {idle}')
    t0 = time.perf_counter()
    want_b = want = oracle_table(dense, bcfg, caller='bhfdr')
    del dense
    max_rel = compare_to_oracle(btable, want)
    lines, want_lines = bhfdr_bedpe_lines(btable), bhfdr_bedpe_lines(want)
    if lines != want_lines:
        diff = sorted(set(lines) ^ set(want_lines))[:4]
        raise AssertionError(f'bedpe lines differ from the oracle\'s: {diff}')
    log(f'[5] oracle ({time.perf_counter() - t0:.1f} s): {len(want)} peaks; '
        f'loci identical, geometry identical, max rel stat diff '
        f'{max_rel:.3g}; {len(lines)} sorted bedpe lines identical')

    # --- 6: pyBHFDR at chr1 scale and its default span ---
    num = maxapart // RES + MAXWW + 1
    t0 = time.perf_counter()
    bands, _, _ = synth_bands(24900, maxapart, seed=42, n_loops=2000,
                              span=num - MAXWW - 54, lane_pad=4096)
    n_cand = bands.candidate_total(bcfg.ww, maxapart // RES)
    log(f'[6] pyBHFDR at chr1 scale: bands {bands.raw.shape}, {n_cand} '
        f'candidates (synthesized in {time.perf_counter() - t0:.1f} s)')
    b_launches, _ = steady_walls(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, device=device),
        n_cand, '[6] bhfdr_chrom')
    mesh_b = (bands, bcfg, n_cand)
    idle = [n for n in ('scan_pass_a', 'scan_pass_b') if b_launches[n] < 1]
    if idle:
        raise AssertionError(f'pyBHFDR path did not launch {idle}')
    chr1_b = kernel_checks(bands, bcfg, device, reps=10, caller='bhfdr')

    # --- 7: deep data, at the count caps of real-depth Hi-C ---
    shapes, deep_launches = deep_data(streams_a, device, counters)
    del streams_a

    # --- 8: the fallback ladder ---
    ladder_launches, crossing_recs = ladder(
        bench_bands, HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW,
                                   maxapart=2_000_000),
        bcfg, want_h, want_b, chr1_run, device, counters)
    del chr1_run

    # --- 11a, 11b: four tiles of one mesh on the card ---
    mesh_out = mesh_tiles(device, counters,
                       (bench_bands, HiccupsConfig(pw=PW, ww=WW, maxww=MAXWW,
                                                   maxapart=2_000_000),
                        bcfg, want_h, want_b), mesh_h, mesh_b)
    del mesh_h, mesh_b

    # --- 9, 10: the user pipeline from TXT to bedpe, coolers through
    # h5lite, and the figures; then 11c and 11d on its coolers ---
    kernel_ms = {'pyHICCUPS': {k: r['ms'] for k, r in chr1.items()},
                 'pyBHFDR': {k: r['ms'] for k, r in chr1_b.items()}}
    pipeline = user_pipeline(device, counters,
                             trace=dict(smi=smi, kernel_ms=kernel_ms))
    mesh_out.update(pipeline['multi'])
    log(json.dumps({'multi': mesh_out}))

    for tool in ('pyHICCUPS', 'pyBHFDR'):
        r = pipeline['trace'][tool]
        defaults[f'api_chr1_{tool}'] = dict(
            peaks=r['peaks'], equal=True, launches=r['jax_form_launches'],
            wall_s=r['plain_wall_s'])
    log('defaults: ' + json.dumps(defaults))
    log(smi)
    # the main keys are the pyHICCUPS path at chr1 scale (phase 4); the
    # prefixed ones the other shapes, plans and the pyBHFDR caller
    keys = ('max_abs_err', 'ms', 'single_ms', 'batched_ms', 'plain_ms',
            'bound_ms', 'bound_by', 'library_ms')
    records = []
    for name, source, replaces in KERNELS + COUNTED:
        rec = dict(name=name, route='cuda', source=source, replaces=replaces,
                   launches=launches[name],
                   **{k: chr1[name][k] for k in keys if name in chr1},
                   bench_launches=bench_launches[name],
                   bhfdr_launches=b_launches[name],
                   deep_launches=deep_launches[name],
                   **{f'{tag}_launches': n[name]
                      for tag, n in ladder_launches.items()},
                   pipeline_hiccups_launches=pipeline['clis']['pyHICCUPS'][
                       'launches'][name],
                   pipeline_bhfdr_launches=pipeline['clis']['pyBHFDR'][
                       'launches'][name],
                   genome_launches=pipeline['genome']['launches'][name],
                   trace_hiccups_launches=pipeline['trace']['pyHICCUPS'][
                       'launches'][name],
                   trace_bhfdr_launches=pipeline['trace']['pyBHFDR'][
                       'launches'][name],
                   staging_hiccups_launches=pipeline['staging'][
                       'pyHICCUPS']['launches'][name],
                   staging_bhfdr_launches=pipeline['staging']['pyBHFDR'][
                       'launches'][name],
                   **{f'multires_{res}_launches': r['launches'][name]
                      for res, r in pipeline['figures']['multires'][
                          'res'].items()},
                   **{'mesh4.launches': mesh_out['hiccups_launches'][name],
                      'mesh4.bhfdr_launches':
                          mesh_out['bhfdr_launches'][name],
                      'global2x2.launches': [
                          g['launches'][name]
                          for g in mesh_out['global']['hiccups']],
                      'global2x2.bhfdr_launches': [
                          g['launches'][name]
                          for g in mesh_out['global']['bhfdr']]})
        for tag, r in (('bench', bench), ('multi_pair', multi),
                       ('bhfdr', chr1_b), ('bhfdr_bench', bench_b),
                       ('quickstart', chr1_b6)):
            if name in r:
                rec.update({f'{tag}_{k}': r[name][k] for k in keys})
        if name in crossing_recs:
            rec.update({f'crossing_{k}': crossing_recs[name][k]
                        for k in ('max_abs_err', 'ms', 'single_ms',
                                  'batched_ms', 'bound_ms', 'bound_by')})
        if name == 'chunk_hist':
            for tag, r in shapes.items():
                rec.update({f'shape_{tag}_{k}': r[k] for k in keys})
        records.append(rec)
    # --- 14: the fused scorer's kernels, a call on every route ---
    score_launches(records)
    log(json.dumps({'kernels': records}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
