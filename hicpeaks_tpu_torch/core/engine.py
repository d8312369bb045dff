"""Per-chromosome pyHICCUPS and pyBHFDR engines on one device (PyTorch).

Port of the fused paths of ``hicpeaks_tpu/core/engine.py``:

* ``hiccups_chrom`` -> ``_hiccups_fused`` -> ``_fused_hiccups_device``:
  the sheets, pass A (CUDA kernel), the freeze gate, pass B (CUDA kernel)
  and the batched scorer with its (chunk, count) histogram (CUDA kernel)
  and keep-mask compaction;
* ``bhfdr_chrom`` -> ``_bhfdr_fused`` -> ``_fused_bhfdr_device``: the
  sheets, pass A, the pyBHFDR freeze gate (plain break), pass B and the
  sort-free global-BH keep superset with its compaction.

On the host: the float64 completion of the compacted pixels
(:mod:`.hostcomplete`), the fold gates, the cross-pair merge and the
clustering (``hicpeaks_tpu.core.clustering``).

The non-fused fallback ladder is not ported (ROADMAP.md, Queue 1 item 10).
Every case that would take it raises NotImplementedError naming that item:
a candidate total too large for the int32 freeze gate, a count above the
histogram cap, a failed suspect audit, a device mesh, and checkify.
"""
from __future__ import annotations

import numpy as np
import torch

from hicpeaks_tpu.core import poolplan as host_poolplan
from hicpeaks_tpu.core.clustering import local_clustering
from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
from hicpeaks_tpu.ops.band import ChromBands

from ..ops import cuda_scan
from ..ops import score as score_ops
from . import poolplan
from .hostcomplete import FALLBACK_ITEM, _bhfdr_to_host, _compact_to_host

_BH_SLACK = 0.01   # chunk_bh_keep superset inflation: covers the f32 qtab's
                   # gammainc error near q ~ sig, so the device keep mask is
                   # a superset of the float64 rejection set

_MAX_O_CAP = 1 << 17   # the histogram-BH count cap (engine._bh_plan)

_BHFDR_THR = 16   # pyBHFDR's fixed local-reads freeze threshold
                  # (callers.py:505); BHFDRConfig has no such field


def resolve_device(device):
    """``device`` as a torch.device; a CUDA device on a machine without
    CUDA raises RuntimeError rather than running anywhere else."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           'available')
    return device


def _refuse_unported(mesh, check, total):
    """NotImplementedError for the cases that need the non-fused ladder."""
    if mesh is not None or check:
        raise NotImplementedError(
            'mesh runs and checkify instrumentation take the non-fused '
            f'path; {FALLBACK_ITEM}')
    if 10 * total >= (1 << 31):
        raise NotImplementedError(
            f'{total} candidate pixels overflow the int32 freeze gate; the '
            f'host freeze replay it needs is part of {FALLBACK_ITEM}')


def bands_to_device(bands: ChromBands, device):
    """The chromosome's device operands (raw, w0, bias, IR, gap) as
    tensors, with the numpy dtypes kept (the port's
    ``stage_chrom_arrays``)."""
    return {k: torch.as_tensor(np.ascontiguousarray(getattr(bands, k)),
                               device=device)
            for k in ('raw', 'w0', 'bias', 'IR', 'gap')}


def _chunk_margin(plan):
    """Provable |t_f32 - t_f64| bound for t = 3*log2(E): the
    cancellation-free ring accumulation plus the ratio/EM/Bprod
    arithmetic, dt = 3/ln2 * relE, and a pad for the f32 log."""
    maxw = max(e.w for e in plan)
    cells = (2 * maxw + 1) ** 2
    return 3.0 / 0.6931471805599453 * (3 * cells + 8) * 2.0 ** -24 + 5e-5


def _bh_plan(max_count):
    """The histogram-BH count cap ``o_cap``: a power of two >= 1024 and >=
    the chromosome's max count."""
    if max_count > _MAX_O_CAP:
        raise NotImplementedError(
            f'max count {max_count} exceeds the histogram cap {_MAX_O_CAP};'
            f' the host BH scorer it needs is part of {FALLBACK_ITEM}')
    o_cap = 1024
    while o_cap < int(max_count):
        o_cap *= 2
    return o_cap


def _exact_capable(bands):
    """Whether the bands carry the float64 vectors and the host raw slab
    that float64 completion reads."""
    return (getattr(bands, 'w064', None) is not None
            and isinstance(getattr(bands, 'raw', None), np.ndarray))


def _exact_ctx(bands, plan, allowed, thr):
    """ExactCtx for float64 host completion, or None without it."""
    if not _exact_capable(bands):
        return None
    from hicpeaks_tpu.ops.hostexact import ExactCtx
    return ExactCtx(bands, plan, allowed, thr)


def _gather_flat_b(a, d, x):
    """a[b, d[b, k], x[b, k]] over a [B, num_p, Lp] sheet."""
    B, _, Lp = a.shape
    return torch.gather(a.reshape(B, -1), 1,
                        (d.to(torch.int64) * Lp + x))


def _gather_flat_shared(a, d, x):
    """a[d[b, k], x[b, k]] over a shared [num_p, Lp] sheet."""
    return a.reshape(-1)[d.to(torch.int64) * a.shape[1] + x]


def _compact_batched(raw, cband, IR, Bprod, BSV, BEV, wis_t, cand, gap_drop,
                     sig, L, o_cap, exact_mode, margin, s_rows):
    """All B backgrounds (every (p, w) pair x {K, Y}) scored in one
    batched body: expected values, lambda chunks, histogram BH keep mask
    (one histogram launch for all B), gap filter and compaction.

    Returns the 10-slot bundle with a leading [B] axis: (cnt, d, x, O, ICE,
    Fold, cid, hist [B, S, C], prod [B, num_p, Lp], suspects) with the
    suspect bundle (cnt, d, x, cid, O, gap, thr) or () without
    ``exact_mode``."""
    wi_b = wis_t[:, None, None]
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        raw, cband, IR, Bprod, BSV, BEV, wi_b, cand, L)
    B = E.shape[0]
    cid, _rv, valid = score_ops.lambda_chunks(E, scored)
    keep_q, _qtab, hist, thr2 = score_ops.chunk_bh_keep_batched(
        O, cid, valid, sig, B, n_chunks=s_rows, o_cap=o_cap,
        slack=_BH_SLACK)
    hist_b = hist.reshape(B, s_rows, o_cap + 1)
    keep = scored & keep_q & ~gap_drop
    sus_bundle = ()
    gb = _gather_flat_b
    gu = _gather_flat_shared
    if exact_mode:
        sus = score_ops.lambda_suspects(E, scored, margin)
        keep = keep & ~sus
        cnt_s, d_s, x_s = score_ops.compact_mask_batched(sus)
        cid_s = torch.where(gb(valid, d_s, x_s), gb(cid, d_s, x_s), 0)
        O_s = torch.clamp(torch.floor(gu(O, d_s, x_s)), 0, o_cap) \
            .to(torch.int32)
        sus_bundle = (cnt_s, d_s, x_s, cid_s, O_s, gu(gap_drop, d_s, x_s),
                      thr2)
    cnt, d_idx, x_idx = score_ops.compact_mask_batched(keep)
    cid_g = torch.where(gb(valid, d_idx, x_idx), gb(cid, d_idx, x_idx), 0)
    return (cnt, d_idx, x_idx, gu(O, d_idx, x_idx), gu(ICE, d_idx, x_idx),
            gb(Fold, d_idx, x_idx), cid_g, hist_b, prod, sus_bundle)


def _bundle_slice(out, lo, hi):
    """Every leaf of a batched bundle along its leading axis."""
    head = tuple(a[lo:hi] for a in out[:9])
    sus = tuple(a[lo:hi] for a in out[9]) if out[9] else ()
    return head + (sus,)


def _fused_hiccups_device(raw, w0, bias, IR, gap, sig, total, t_left,
                          plan, p_list, thr, ww_t, wis, ww_min, L, d_lo,
                          d_hi, gap_s, o_cap, exact_mode, margin, s_rows):
    """The per-chromosome device pipeline: sheets, pass A, the freeze gate
    (integer-exact, so it equals the host replay), pass B and the batched
    scorer.  ``wis`` is the ((p, w), ...) pair list.  Returns (counts,
    allowed, outK, outY), each bundle with a leading n_pairs axis."""
    raw, cband, eband, Bprod, gap_drop, cand = score_ops.build_sheets(
        raw, w0, bias, IR, gap, ww_min, L, d_lo, d_hi, gap_s)
    counts = cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr)
    allowed = poolplan.device_allowed_hiccups(counts, total, t_left, plan,
                                              ww_t)
    outs = cuda_scan.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                 p_list, thr)
    n = len(wis)
    BSV = torch.stack([outs[p][0] for p, _ in wis]
                      + [outs[p][2] for p, _ in wis])
    BEV = torch.stack([outs[p][1] for p, _ in wis]
                      + [outs[p][3] for p, _ in wis])
    wis_t = torch.tensor([w for _, w in wis] * 2, dtype=torch.int32,
                         device=raw.device)
    out = _compact_batched(raw, cband, IR, Bprod, BSV, BEV, wis_t, cand,
                           gap_drop, sig, L, o_cap, exact_mode, margin,
                           s_rows)
    return counts, allowed, _bundle_slice(out, 0, n), \
        _bundle_slice(out, n, 2 * n)


def _score_device_bhfdr_compact(raw, cband, IR, Bprod, bSV, bEV, cand,
                                gap_drop, sig, wi, L):
    """Global-BH scoring of the donut background: p-values, the sort-free
    keep superset (``score_ops.global_bh_keep``) and its row-major
    compaction.  Gap pixels stay in the superset: the gap filter comes
    after BH, on the host.

    Returns the 11-slot bundle (cnt, d, x, O, ICE, Fold, p, E, m, gap,
    prod)."""
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        raw, cband, IR, Bprod, bSV, bEV, wi, cand, L)
    pval = torch.where(scored, score_ops.poisson_sf(O, E), 1.0)
    keep_sup, m, _ = score_ops.global_bh_keep(pval, scored, sig)
    cnt, d_idx, x_idx = score_ops.compact_mask(keep_sup)
    small = [_gather_flat_shared(a, d_idx, x_idx)
             for a in (O, ICE, Fold, pval, E, gap_drop)]
    return (cnt, d_idx, x_idx, *small[:5], m, small[5], prod)


def _fused_bhfdr_device(raw, w0, bias, IR, gap, sig, total, t_left, plan,
                        p_list, thr, wi, ww_min, L, d_lo, d_hi, gap_s):
    """The per-chromosome pyBHFDR device pipeline: sheets, pass A, the
    plain-break freeze gate, pass B and the global-BH scorer of the donut
    background.  Returns (counts, allowed, bundle)."""
    raw, cband, eband, Bprod, gap_drop, cand = score_ops.build_sheets(
        raw, w0, bias, IR, gap, ww_min, L, d_lo, d_hi, gap_s)
    counts = cuda_scan.scan_pass_a(raw, cand, plan, p_list, thr)
    allowed = poolplan.device_allowed_bhfdr(counts, total, t_left, plan)
    outs = cuda_scan.scan_pass_b(raw, cband, eband, cand, allowed, plan,
                                 p_list, thr)
    KS, KE, _, _ = outs[p_list[0]]
    out = _score_device_bhfdr_compact(raw, cband, IR, Bprod, KS, KE, cand,
                                      gap_drop, sig, wi, L)
    return counts, allowed, out


def _to_host(tree):
    """Tensors -> numpy arrays through nested tuples."""
    if isinstance(tree, tuple):
        return tuple(_to_host(t) for t in tree)
    return tree.cpu().numpy()


def _hiccups_fused(bands: ChromBands, cfg: HiccupsConfig, plan, p_list,
                   pairs, total, o_cap, device):
    """One chromosome through the device pipeline and one fetch of the
    compacted bundles, completed to per-pair (rK, rY) host dicts."""
    ops = bands_to_device(bands, device)
    exact_mode = _exact_capable(bands)
    counts, allowed_d, outK, outY = _fused_hiccups_device(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        cfg.siglevel, total, host_poolplan.left_threshold(total),
        plan=plan, p_list=p_list, thr=cfg.min_local_reads,
        ww_t=tuple(cfg.ww), wis=tuple((int(p), int(w)) for p, w in pairs),
        ww_min=bands.ww_min, L=int(bands.L), d_lo=min(cfg.ww),
        d_hi=cfg.maxapart // bands.res, gap_s=min(cfg.ww), o_cap=o_cap,
        exact_mode=exact_mode, margin=_chunk_margin(plan),
        s_rows=score_ops.chunk_rows(o_cap, cfg.siglevel))
    counts_h, allowed_h, fK_all, sK, fY_all, sY = _to_host(
        (counts, allowed_d, outK[:8], outK[9], outY[:8], outY[9]))
    decision = host_poolplan.emulate_freeze_hiccups(plan, counts_h, total,
                                                    cfg.ww)
    if not np.array_equal(allowed_h, np.asarray(decision.allowed)):
        raise AssertionError(
            'device freeze emulation diverged from the host replay')
    ctx = _exact_ctx(bands, plan, decision.allowed, cfg.min_local_reads)
    results = []
    for i, (pi, _) in enumerate(pairs):
        rK = _compact_to_host(tuple(l[i] for l in fK_all), (outK[8], i),
                              sig=cfg.siglevel,
                              exact=ctx and (ctx, pi, 'K'),
                              sus=tuple(l[i] for l in sK) if sK else None)
        rY = _compact_to_host(tuple(l[i] for l in fY_all), (outY[8], i),
                              sig=cfg.siglevel,
                              exact=ctx and (ctx, pi, 'Y'),
                              sus=tuple(l[i] for l in sY) if sY else None)
        results.append((rK, rY))
    return results


def hiccups_chrom(bands: ChromBands, cfg: HiccupsConfig, device,
                  mesh=None, check=False):
    """Two-background multi-parameter caller (reference callers.py:44-362)
    on one ``device``.  Returns {(x_bp, y_bp): (cen_x, cen_y, radius, O,
    FoldK, pK, qK, FoldY, pY, qY)} in bp, the table of
    ``hicpeaks_tpu.core.engine.hiccups_chrom``.

    On a CUDA device the bands must be float32 (the kernels take float32
    sheets and raise otherwise); on the CPU float64 bands compute what the
    JAX engine computes under x64."""
    device = resolve_device(device)
    res = bands.res
    pw, ww = tuple(cfg.pw), tuple(cfg.ww)
    plan = tuple(host_poolplan.hiccups_pool_plan(pw, ww, cfg.maxww))
    p_list = tuple(sorted(set(pw)))
    total = bands.candidate_total(min(ww), cfg.maxapart // res)
    pairs = list(zip(pw, ww))
    _refuse_unported(mesh, check, total)
    max_count = getattr(bands, 'max_count', None)
    if max_count is None:
        max_count = float(bands.raw.max())
    o_cap = _bh_plan(max_count)
    results = _hiccups_fused(bands, cfg, plan, p_list, pairs, total, o_cap,
                             device)

    pixel_table = {}
    for pair_idx, (pi, wi) in enumerate(pairs):
        rK, rY = results[pair_idx]

        first = rK['O'] if cfg.use_raw else rK['ICE']
        preDonuts = {(int(x), int(y)): (fi, o, f, p, q)
                     for x, y, fi, o, f, p, q in zip(
                         rK['x'], rK['y'], first, rK['O'], rK['Fold'],
                         rK['p'], rK['q'])}
        preLL = {(int(x), int(y)): (i, o, f, p, q)
                 for x, y, i, o, f, p, q in zip(
                     rY['x'], rY['y'], rY['ICE'], rY['O'], rY['Fold'],
                     rY['p'], rY['q'])}

        commonPos = set(preDonuts) & set(preLL)
        postcheck = set(preDonuts) - set(preLL)
        if postcheck:
            # cEM here is the Y background's expected matrix (the reference
            # reuses the loop variable, callers.py:329-331); it stays on the
            # device and only the postcheck entries are gathered
            pc = list(postcheck)
            stacked, i = rY['prod']
            di = torch.tensor([cj - ci for ci, cj in pc], dtype=torch.int64,
                              device=stacked.device)
            xi = torch.tensor([ci for ci, _ in pc], dtype=torch.int64,
                              device=stacked.device)
            vals = stacked[i, di, xi].cpu().numpy()
            for (ci, cj), v in zip(pc, vals):
                if v == 0:
                    commonPos.add((ci, cj))

        for key in commonPos:
            donut = preDonuts[key]
            ll = preLL.get(key, donut)
            bpkey = (key[0] * res, key[1] * res)
            if (donut[2] > cfg.double_fold) and (ll[2] > cfg.double_fold) and \
                    ((donut[2] > cfg.single_fold) or (ll[2] > cfg.single_fold)):
                if bpkey not in pixel_table:
                    pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]
                elif (donut[-1] < pixel_table[bpkey][7]) and \
                        (ll[-1] < pixel_table[bpkey][10]):
                    pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]

    Donuts = {(k[0] // res, k[1] // res): pixel_table[k][3:8]
              for k in pixel_table}
    LL = {(k[0] // res, k[1] // res): pixel_table[k][8:] for k in pixel_table}
    peak_list = local_clustering(Donuts, LL, res,
                                 min_count=cfg.min_marginal_peaks,
                                 r=2 * res, sumq=cfg.sumq,
                                 onlysummit=cfg.only_anchors)
    final_table = {}
    for pixel, cen, radius in peak_list:
        key = (pixel[0] * res, pixel[1] * res)
        final_table[key] = (cen[0] * res, cen[1] * res, radius * res) + \
            pixel_table[key][4:]
    return final_table


def _bhfdr_fused(bands: ChromBands, cfg: BHFDRConfig, plan, total, device):
    """One chromosome through the pyBHFDR device pipeline and one fetch of
    the compacted bundle, completed to the host dict of its significant
    pixels."""
    ops = bands_to_device(bands, device)
    counts, allowed_d, out = _fused_bhfdr_device(
        ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
        cfg.siglevel, total, host_poolplan.left_threshold(total),
        plan=plan, p_list=(cfg.pw,), thr=_BHFDR_THR, wi=int(cfg.ww),
        ww_min=bands.ww_min, L=int(bands.L), d_lo=cfg.ww,
        d_hi=cfg.maxapart // bands.res, gap_s=cfg.ww)
    counts_h, allowed_h, fetched = _to_host((counts, allowed_d, out[:10]))
    decision = host_poolplan.emulate_freeze_bhfdr(plan, counts_h, total)
    if not np.array_equal(allowed_h, np.asarray(decision.allowed)):
        raise AssertionError(
            'device freeze emulation diverged from the host replay')
    ctx = _exact_ctx(bands, plan, decision.allowed, _BHFDR_THR)
    return _bhfdr_to_host(fetched, out[10], cfg.siglevel,
                          exact=ctx and (ctx, cfg.pw, 'K'))


def bhfdr_chrom(bands: ChromBands, cfg: BHFDRConfig, device, mesh=None,
                check=False):
    """Donut-only caller with one global BH (reference callers.py:364-590)
    on one ``device``.  Returns {(x_bp, y_bp): (cen_x, cen_y, radius, O,
    Fold, p, q)} in bp, the table of
    ``hicpeaks_tpu.core.engine.bhfdr_chrom``; the dtype rules are those of
    :func:`hiccups_chrom`."""
    device = resolve_device(device)
    res = bands.res
    plan = tuple(host_poolplan.bhfdr_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
    total = bands.candidate_total(cfg.ww, cfg.maxapart // res)
    _refuse_unported(mesh, check, total)
    r = _bhfdr_fused(bands, cfg, plan, total, device)

    # insertion order is output order: Donuts follows the row-major
    # compaction, and the clustering and the bedpe writer iterate it
    Donuts = {(int(x), int(y)): (float(o), float(f), float(p), float(q))
              for x, y, o, f, p, q in zip(r['x'], r['y'], r['O'], r['Fold'],
                                          r['p'], r['q'])}
    pixel_list = local_clustering(Donuts, None, res,
                                  min_count=cfg.min_marginal_peaks,
                                  r=2 * res, onlysummit=cfg.only_anchors)
    pixel_table = {}
    for pixel, cen, radius in pixel_list:
        donut = Donuts[pixel]
        if donut[1] > 2:   # post-clustering fold gate, callers.py:587
            pixel_table[(pixel[0] * res, pixel[1] * res)] = \
                (cen[0] * res, cen[1] * res, radius * res) + donut
    return pixel_table
