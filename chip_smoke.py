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
   equal; times by CUDA events (median of repeats), each beside its bound
   (the least time for its bytes and operations at the H100's peaks) and,
   for the histogram, beside one ``torch.bincount`` of the same inputs;
   then the scan kernels again on the multi-pair plan pw=(1, 2),
   ww=(3, 5), maxww=10, whose drift re-adds read kept rings;
3. the main path, ``hiccups_chrom`` on the card, with every kernel's
   launch count, and its table against the float64 oracle
   (tests/oracle/reference_impl.py): identical loci and geometry, max
   relative stat difference < 1e-8;
4. chr1 scale at the CLI default span (L=24,900 at 10 kb, 10 Mb): the
   main path's kernel launches in its first call and the steady
   per-chromosome wall of the second, and the kernel checks of phase 2
   on that chromosome's sheets;
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
   ``user_pipeline`` JSON line.

    python3 chip_smoke.py --crossing-only

runs phases 1 and 8f alone, in a process that holds nothing else, and
prints no result line; ``--pipeline-only`` does the same for phase 9.

The line before the last is one JSON object with a record per kernel (its
main keys from phase 4, the others prefixed by phase or histogram shape);
the last line is {"ok": true, "device": {...}}.
"""
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
KERNELS = (
    ('scan_pass_a', 'hicpeaks_tpu_torch/csrc/scan_pass_a.cu',
     'hicpeaks_tpu/ops/pallas_scan.py:141'),
    ('scan_pass_b', 'hicpeaks_tpu_torch/csrc/scan_pass_b.cu',
     'hicpeaks_tpu/ops/pallas_scan.py:222'),
    ('chunk_hist', 'hicpeaks_tpu_torch/csrc/chunk_hist.cu',
     'hicpeaks_tpu/ops/pallas_hist.py:46'),
)


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


def bound_ms(bytes_, ops):
    """The least time the card could take for ``bytes_`` moved once and
    ``ops`` float32 operations: the larger of the two times at the H100
    SXM's published peaks (3.35 TB/s HBM3, 67 TFLOP/s f32 outside the
    tensor cores), and which one it is."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by='bytes' if t_bytes >= t_ops else 'operations',
                bytes=int(bytes_), ops=int(ops))


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
        ms=cuda_ms(lambda: kernel(oc, cid0, S, C), reps),
        plain_ms=cuda_ms(lambda: cuda_hist.chunk_hist_torch(oc, cid0, S, C),
                         reps),
        library_ms=cuda_ms(lambda: torch.bincount(flat, minlength=B * S * C),
                           reps),
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
        ms=cuda_ms(lambda: cuda_scan.scan_pass_a(raw, cand, plan, p_list,
                                                 thr), reps),
        plain_ms=cuda_ms(lambda: twin.scan_pass_a(raw, cand, plan, p_list,
                                                  thr), reps),
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
        ms=cuda_ms(lambda: cuda_scan.scan_pass_b(*args_b), reps),
        plain_ms=cuda_ms(lambda: twin.scan_pass_b(*args_b), reps),
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
            f'kernel {r["ms"]:.3f} ms, twin {r["plain_ms"]:.3f} ms{lib}; '
            f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}: {r["bytes"]} B, '
            f'{r["ops"]} ops), {r["bound_ms"] / r["ms"]:.1%} of it')
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


def oracle_table(dense, cfg, caller='hiccups'):
    """The float64 oracle's table on the dense inputs of
    :func:`dense_inputs`."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    from oracle import reference_impl as oracle_mod
    args = (dense['Md'], dense['cMd'], dense['B'], dense['B'], dense['IR'],
            dense['L'], dense['num'])
    if caller == 'bhfdr':
        return oracle_mod.bhfdr(*args, pw=cfg.pw, ww=cfg.ww,
                                sig=cfg.siglevel, maxww=cfg.maxww,
                                maxapart=cfg.maxapart, res=RES,
                                min_marginal_peaks=cfg.min_marginal_peaks,
                                onlyanchor=cfg.only_anchors)
    return oracle_mod.hiccups(
        *args, pw=cfg.pw, ww=cfg.ww, sig=cfg.siglevel, sumq=cfg.sumq,
        maxww=cfg.maxww, maxapart=cfg.maxapart, res=RES,
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
            f'{r["ms"]:.4f} ms, twin {r["plain_ms"]:.3f} ms, torch.bincount '
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
    idle = [n for n, c in launches.items() if c < 1]
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
    host clock between device syncs; returns (wall s, {name: s}).  The
    stages nest in no other stage."""
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
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(module, n, real[n])
    return wall, spent


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
        wall, spent = staged(
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
        scan_pass_a=dict(max_abs_err=0.0, ms=cuda_ms(
            lambda: cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr), 3),
            **bound_ms(bytes_=5 * positions + 4 * len(plan),
                       ops=3 * maxw * positions + reads_adds * n_cand)),
        scan_pass_b=dict(max_abs_err=0.0, ms=cuda_ms(
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
    return runs, crossing_recs


def run_cli(module, args, log_file):
    """``python -m hicpeaks_tpu_torch.cli.<module> args`` in a process of
    its own from the checkout; raises on a non-zero exit (with the log's
    tail); returns its wall in seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', f'hicpeaks_tpu_torch.cli.{module}', *args,
         '--logFile', log_file], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    dt = time.perf_counter() - t0
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


def cli_check(device, tmp, counters, L=24900):
    """Phase 9b: phase 4's chr1 (10 kb, L = 24,900, seed 42, 2000 loops)
    written as a cooler, balanced on the card, then both CLIs from it on
    the card against the in-process engines on the same cooler's bands."""
    import numpy as np
    import torch
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                                  create_cooler_file)
    from hicpeaks_tpu_torch.io.peakfile import (write_bhfdr_bedpe,
                                                write_hiccups_bedpe)
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops import ice
    from hicpeaks_tpu_torch.ops.band import bands_from_cooler
    num = 10_000_000 // RES + MAXWW + 1
    b1, b2, ct, _, _ = synthesize_chrom(
        n_bins=L, res=RES, seed=42, depth=40.0, n_loops=2000, decay=0.75,
        max_loop_span_bins=num - MAXWW - 54)
    cool = os.path.join(tmp, 'chr1.cool')
    uri = f'{cool}::{RES}'
    t0 = time.perf_counter()
    create_cooler_file(uri, binnify({'1': L * RES}, RES),
                       [{'bin1_id': b1, 'bin2_id': b2, 'count': ct}],
                       metadata={'onlyIntra': 'True'})
    t_write = time.perf_counter() - t0
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
            ['chunk_hist'] if tool == 'pyHICCUPS' else [])
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


def genome_check(device, tmp, counters, sizes=HG38):
    """Phase 9c: a synthetic genome (HG38, 10 kb, pixels within 2 Mb)
    written by the port's writer, balanced on the card, then
    ``call_bhfdr`` on the card; walls by stage and by chromosome."""
    import logging
    import re
    import numpy as np
    import torch
    from hicpeaks_tpu_torch import api
    from hicpeaks_tpu_torch.core.config import BHFDRConfig
    from hicpeaks_tpu_torch.io.coolerlite import (CoolerLite, binnify,
                                                  create_cooler_file)
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
    return dict(chroms=len(sizes), bins=offset, pixels=n_px,
                synth_s=t_synth, write_s=t_write, ice_s=t_ice,
                call_s=t_call, peaks=n_peaks, peak_gib=peak_gb,
                file_mib=size_mb, launches=launches, per_chrom=per_chrom)


def user_pipeline(device, counters):
    """Phase 9: the user pipeline on the card, every cooler read and
    written through the port's h5lite (the host has no h5py): (a) TXT ->
    toCooler, (b) both CLIs from a cooler, (c) a genome.  Its files live
    under build/smoke/ and are removed afterwards."""
    import shutil
    tmp = os.path.join(REPO, 'build', 'smoke')
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        log('[9] the user pipeline: TXT -> toCooler -> CLIs -> bedpe')
        out = dict(ingest=ingest_check(device, tmp),
                   clis=cli_check(device, tmp, counters),
                   genome=genome_check(device, tmp, counters))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(json.dumps({'user_pipeline': out}))
    return out


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--crossing-only', action='store_true',
                    help='run phases 1 and 8f alone')
    ap.add_argument('--pipeline-only', action='store_true',
                    help='run phases 1 and 9 alone')
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port does not run its '
              'kernels on the CPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from hicpeaks_tpu_torch.core import engine
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.kernels import build
    from hicpeaks_tpu_torch.ops import cuda_hist, cuda_scan

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
                cuda_hist.chunk_hist)
    if args.crossing_only or args.pipeline_only:
        if args.crossing_only:
            crossing(device, counters)
        if args.pipeline_only:
            user_pipeline(device, counters)
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
    idle = [n for n, c in bench_launches.items() if c < 1]
    if idle:
        raise AssertionError(f'main path did not launch {idle}')
    t0 = time.perf_counter()
    # pyHICCUPS's min(ww) and pyBHFDR's ww are both 5: one set of dense
    # inputs serves phases 3 and 5
    dense = dense_inputs(bands, w, bias_vec, min(WW))
    want_h = want = oracle_table(dense, cfg)
    max_rel = compare_to_oracle(table, want)
    log(f'[3] oracle ({time.perf_counter() - t0:.1f} s): {len(want)} peaks; '
        f'loci identical, geometry identical, max rel stat diff {max_rel:.3g}')

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
    idle = [n for n, c in launches.items() if c < 1]
    if idle:
        raise AssertionError(f'main path did not launch {idle}')
    streams_a = {}
    chr1 = kernel_checks(bands, cfg, device, reps=10, keep=streams_a)

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

    # --- 9: the user pipeline from TXT to bedpe, coolers through h5lite ---
    pipeline = user_pipeline(device, counters)

    log(smi)
    # the main keys are the pyHICCUPS path at chr1 scale (phase 4); the
    # prefixed ones the other shapes, plans and the pyBHFDR caller
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    records = []
    for name, source, replaces in KERNELS:
        rec = dict(name=name, route='cuda', source=source, replaces=replaces,
                   launches=launches[name],
                   **{k: chr1[name][k] for k in keys},
                   bench_launches=bench_launches[name],
                   bhfdr_launches=b_launches[name],
                   deep_launches=deep_launches[name],
                   **{f'{tag}_launches': n[name]
                      for tag, n in ladder_launches.items()},
                   pipeline_hiccups_launches=pipeline['clis']['pyHICCUPS'][
                       'launches'][name],
                   pipeline_bhfdr_launches=pipeline['clis']['pyBHFDR'][
                       'launches'][name],
                   genome_launches=pipeline['genome']['launches'][name])
        for tag, r in (('bench', bench), ('multi_pair', multi),
                       ('bhfdr', chr1_b), ('bhfdr_bench', bench_b)):
            if name in r:
                rec.update({f'{tag}_{k}': r[name][k] for k in keys})
        if name in crossing_recs:
            rec.update({f'crossing_{k}': crossing_recs[name][k]
                        for k in ('max_abs_err', 'ms', 'bound_ms',
                                  'bound_by')})
        if name == 'chunk_hist':
            for tag, r in shapes.items():
                rec.update({f'shape_{tag}_{k}': r[k] for k in keys})
        records.append(rec)
    log(json.dumps({'kernels': records}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
