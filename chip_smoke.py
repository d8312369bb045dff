#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hicpeaks_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository checkout around this file;
imports neither JAX nor h5py.  It exits non-zero on any failure, and
without a CUDA card.  Phases:

1. the card (nvidia-smi) and the kernels' build from csrc/;
2. each CUDA kernel against its plain PyTorch twin at the bench shape
   (bench.py: L=8192 bins at 10 kb, 2 Mb span, pw=2, ww=5, maxww=10,
   seed 0): pass-A counts equal, pass-B captures bit-equal, histogram
   equal; times by CUDA events (median of repeats);
3. the main path, ``hiccups_chrom`` on the card, with every kernel's
   launch count, and its table against the float64 oracle
   (tests/oracle/reference_impl.py): identical loci and geometry, max
   relative stat difference < 1e-8;
4. chr1 scale at the CLI default span (L=24,900 at 10 kb, 10 Mb): the
   steady per-chromosome wall of the second of two runs, and the kernel
   checks of phase 2 on that chromosome's sheets;
5. pyBHFDR at the bench shape and the pyBHFDR CLI defaults (pw=2, ww=5,
   maxww=10, 2 Mb): the scan kernels against their twins on the pyBHFDR
   plan and gate, the global-BH iteration count, ``bhfdr_chrom`` on the
   card with its kernel launch counts, and its table against the float64
   oracle (identical loci and geometry, max relative stat difference
   < 1e-8, identical sorted 13-column bedpe lines);
6. pyBHFDR at chr1 scale (L=24,900 at 10 kb, 2 Mb): the steady wall of the
   second of two ``bhfdr_chrom`` calls, and the scan-kernel checks of
   phase 5 on that chromosome's sheets.

The line before the last is one JSON object with a record per kernel; the
last line is {"ok": true, "device": {...}}.
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
PW, WW, MAXWW = (2,), (5,), 10
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


def synth_bands(L, maxapart, seed, n_loops, span, lane_pad):
    """A synthetic chromosome's host bands, built in memory as bench.py and
    benchmarks/genome_scale.py build theirs."""
    import numpy as np
    from hicpeaks_tpu.ops.band import build_bands
    from hicpeaks_tpu_torch.hostio import synthesize_chrom
    num = maxapart // RES + MAXWW + 1
    b1, b2, ct, _, bias_vec = synthesize_chrom(
        n_bins=L, res=RES, seed=seed, depth=40.0, n_loops=n_loops,
        decay=0.75, max_loop_span_bins=span)
    w = np.full(L, np.nan)
    ok = bias_vec > 0
    w[ok] = 1.0 / bias_vec[ok]
    bands = build_bands(b1, b2, ct, w, L, num, min(WW), RES,
                        dtype=np.float32, lane_pad=lane_pad)
    return bands, w, bias_vec


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up."""
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
    return statistics.median(times)


def max_abs(a, b):
    import torch
    if a.numel() == 0:
        return 0.0
    return float(torch.max(torch.abs(a.double() - b.double())))


def kernel_checks(bands, cfg, device, reps, caller='hiccups'):
    """Each kernel of ``caller``'s path ('hiccups' or 'bhfdr') against its
    twin on the sheets, plan and freeze gate that path gives it.  Raises on
    any disagreement; returns {name: {max_abs_err, ms, plain_ms}}."""
    import torch
    from hicpeaks_tpu.core import poolplan as host_poolplan
    from hicpeaks_tpu_torch.core import engine, poolplan
    from hicpeaks_tpu_torch.ops import cuda_hist, cuda_scan, score
    from hicpeaks_tpu_torch.ops import scan as twin

    res = bands.res
    if caller == 'hiccups':
        plan = tuple(host_poolplan.hiccups_pool_plan(cfg.pw, cfg.ww,
                                                     cfg.maxww))
        p_list = tuple(sorted(set(cfg.pw)))
        thr, d_lo = cfg.min_local_reads, min(cfg.ww)
    else:
        plan = tuple(host_poolplan.bhfdr_pool_plan(cfg.pw, cfg.ww,
                                                   cfg.maxww))
        p_list = (cfg.pw,)
        thr, d_lo = engine._BHFDR_THR, cfg.ww
    total = bands.candidate_total(d_lo, cfg.maxapart // res)
    ops = engine.bands_to_device(bands, device)
    raw, cband, eband, Bprod, gap_drop, cand = score.build_sheets(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        bands.ww_min, bands.L, d_lo, cfg.maxapart // res, d_lo)
    out = {}

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
                                                  thr), reps))

    t_left = host_poolplan.left_threshold(total)
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
        plain_ms=cuda_ms(lambda: twin.scan_pass_b(*args_b), reps))

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
        h_k = cuda_hist.chunk_hist(oc, cid0, S, C)
        h_t = cuda_hist.chunk_hist_torch(oc, cid0, S, C)
        if not torch.equal(h_k, h_t):
            raise AssertionError(
                f'histogram differs by up to {max_abs(h_k, h_t)}')
        out['chunk_hist'] = dict(
            max_abs_err=max_abs(h_k, h_t),
            ms=cuda_ms(lambda: cuda_hist.chunk_hist(oc, cid0, S, C), reps),
            plain_ms=cuda_ms(lambda: cuda_hist.chunk_hist_torch(oc, cid0, S,
                                                                C), reps))
    for name, r in out.items():
        log(f'  {name}: kernel == twin (max abs err {r["max_abs_err"]}); '
            f'kernel {r["ms"]:.3f} ms, twin {r["plain_ms"]:.3f} ms')
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
    from hicpeaks_tpu_torch.hostio import write_bhfdr_bedpe
    buf = io.StringIO()
    write_bhfdr_bedpe(buf, '1', RES, table)
    return sorted(buf.getvalue().splitlines())


def compare_to_oracle(table, want):
    """Raise unless loci and geometry are identical and every statistic
    is within 1e-8 relative; returns the max relative difference."""
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
        max_rel = max(max_rel, float(np.max(
            np.abs(g - v) / np.maximum(np.abs(v), 1e-30))))
    if not max_rel < 1e-8:
        raise AssertionError(f'max relative stat difference {max_rel}')
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


def steady_walls(call, n_cand, tag):
    """Two calls; logs both walls, the second (steady) one as candidate
    pixels per second, and the peak device memory.  Returns the table."""
    import torch
    walls = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        t0 = time.perf_counter()
        table = call()
        walls.append(time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f'{tag} walls {walls[0]:.3f} s, {walls[1]:.3f} s; steady '
        f'{walls[1]:.3f} s = {n_cand / walls[1]:.4g} candidate px/s; '
        f'{len(table)} peaks; peak device memory {peak_gb:.2f} GiB')
    return table


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port does not run its '
              'kernels on the CPU', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.core import engine
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

    # --- 3: the main path at the bench shape, against the oracle ---
    table, t_main, launches = run_counted(
        counters, lambda: engine.hiccups_chrom(bands, cfg, device=device))
    log(f'[3] main path: hiccups_chrom in {t_main:.2f} s (first call), '
        f'{len(table)} peaks; kernel launches {launches}')
    idle = [n for n, c in launches.items() if c < 1]
    if idle:
        raise AssertionError(f'main path did not launch {idle}')
    t0 = time.perf_counter()
    # pyHICCUPS's min(ww) and pyBHFDR's ww are both 5: one set of dense
    # inputs serves phases 3 and 5
    dense = dense_inputs(bands, w, bias_vec, min(WW))
    want = oracle_table(dense, cfg)
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
    steady_walls(lambda: engine.hiccups_chrom(bands, cfg, device=device),
                 n_cand, '[4] hiccups_chrom')
    chr1 = kernel_checks(bands, cfg, device, reps=5)

    # --- 5: pyBHFDR at the bench shape and the pyBHFDR CLI defaults ---
    bands, maxapart = bench_bands, 2_000_000
    bcfg = BHFDRConfig(pw=PW[0], ww=WW[0], maxww=MAXWW, maxapart=maxapart)
    n_cand = bands.candidate_total(bcfg.ww, maxapart // RES)
    log(f'[5] pyBHFDR at the bench shape: bands {bands.raw.shape}, {n_cand} '
        'candidates')
    bench_b = kernel_checks(bands, bcfg, device, reps=10, caller='bhfdr')
    btable, t_b, b_launches = run_counted(
        counters, lambda: engine.bhfdr_chrom(bands, bcfg, device=device))
    log(f'[5] pyBHFDR path: bhfdr_chrom in {t_b:.2f} s (first call), '
        f'{len(btable)} peaks; kernel launches {b_launches}')
    idle = [n for n in ('scan_pass_a', 'scan_pass_b') if b_launches[n] < 1]
    if idle:
        raise AssertionError(f'pyBHFDR path did not launch {idle}')
    t0 = time.perf_counter()
    want = oracle_table(dense, bcfg, caller='bhfdr')
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
    steady_walls(lambda: engine.bhfdr_chrom(bands, bcfg, device=device),
                 n_cand, '[6] bhfdr_chrom')
    chr1_b = kernel_checks(bands, bcfg, device, reps=5, caller='bhfdr')

    log(smi)
    records = []
    for name, source, replaces in KERNELS:
        b, c = bench[name], chr1[name]
        rec = dict(
            name=name, route='cuda', source=source, replaces=replaces,
            launches=launches[name], max_abs_err=b['max_abs_err'],
            ms=b['ms'], plain_ms=b['plain_ms'],
            chr1_max_abs_err=c['max_abs_err'], chr1_ms=c['ms'],
            chr1_plain_ms=c['plain_ms'], bhfdr_launches=b_launches[name])
        if name in bench_b:
            b, c = bench_b[name], chr1_b[name]
            rec.update(
                bhfdr_max_abs_err=b['max_abs_err'], bhfdr_ms=b['ms'],
                bhfdr_plain_ms=b['plain_ms'],
                bhfdr_chr1_max_abs_err=c['max_abs_err'],
                bhfdr_chr1_ms=c['ms'], bhfdr_chr1_plain_ms=c['plain_ms'])
        records.append(rec)
    log(json.dumps({'kernels': records}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
