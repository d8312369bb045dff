"""The benchmark's plain reference of both callers, in band coordinates.

:mod:`.dense` (the frozen float64 oracle) holds whole ``L x L`` matrices:
about 5 GB each at chr1 and 10 kb.  This module computes the same tables
from the same pixels and weights on the upper band alone.  An array
``X[d, x]`` holds the matrix entry ``M[x, x + d]``, so the dense oracle's
read ``M[x + a, y + b]`` of window cell ``(a, b)`` is ``X[d + b - a, x + a]``:
a shifted slice of the band, zero-padded by ``2 * maxww`` diagonals and
``maxww`` bins on each side (the oracle's zero-padded matrix).  Every sum
adds the oracle's window cells in the oracle's order, cell for cell, so
in float64 the window sums, E, Fold and p equal the dense oracle's bit for
bit.  The freeze gate's counts are over the whole chromosome, so the band
is one block: at chr1 and 10 Mb its float64 arrays take about 1.6 GB.

The window sums run as torch ops on ``device`` (the card in the benchmark,
the CPU in its tests); what follows them (lambda-chunks, Poisson tests, BH,
the gap filter, the fold gates and the clustering) is the oracle's numpy
on the host, over candidate vectors instead of dense matrices.

``dtype`` is the precision of every array and sum: float64 is the
reference; float32 is the benchmark's control, the same computation one
precision below the configuration's.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.stats import poisson

from .clustering import local_clustering
from .dense import _in_P1, _in_P2, _pw_ww_pairs, lambdachunk
from .multitest import fdr_bh

_TORCH = {np.dtype(np.float64): torch.float64,
          np.dtype(np.float32): torch.float32}


class Band:
    """One chromosome's inputs in band coordinates: the raw, balanced and
    expected bands padded for shifted reads, the candidates, and the
    vectors the scorers read.  ``b1``/``b2``/``ct`` are the chromosome's
    upper-triangle pixels (bin ids from 0), ``w`` its weights (NaN at
    invalid bins), ``L`` its bins; the band holds diagonals ``0..num-1``
    with ``num = maxapart // res + maxww + 1``, balanced and expected from
    ``ww_min`` up, as the reference's worker prepares them
    (scripts/pyHICCUPS:139-168)."""

    def __init__(self, b1, b2, ct, w, L, res, maxapart, maxww, ww_min,
                 d_lo, device, dtype=np.float64):
        dt = np.dtype(dtype)
        self.dt, self.device = dt, torch.device(device)
        self.L, self.res, self.maxww = int(L), int(res), int(maxww)
        self.num = num = maxapart // res + maxww + 1
        self.d_lo, self.d_hi = int(d_lo), maxapart // res
        b1 = np.asarray(b1, np.int64)
        d = np.asarray(b2, np.int64) - b1
        keep = (d >= 0) & (d < num)
        b1, d = b1[keep], d[keep]
        ct = np.asarray(ct)[keep].astype(dt)
        w = np.asarray(w, np.float64).astype(dt)
        cval = ct * w[b1] * w[b1 + d]          # the cooler's balance order
        nanv = np.isnan(cval)
        cval[nanv] = 0.0
        cval[d < ww_min] = 0.0

        # IR[d]: the NaN-aware mean of balanced diagonal d over its L - d
        # entries, unstored pixels counting as 0 (scripts/pyHICCUPS:150-158)
        self.IR = np.zeros(num, dt)
        order = np.argsort(d.astype(np.int32), kind='stable')
        starts = np.searchsorted(d[order], np.arange(num + 1))
        for dd in range(ww_min, num):
            sl = order[starts[dd]:starts[dd + 1]]
            diag = np.zeros(L - dd, dt)
            diag[b1[sl]] = np.where(nanv[sl], np.nan, cval[sl])
            self.IR[dd] = diag[~np.isnan(diag)].mean()
        valid = ~((w == 0) | np.isnan(w))
        self.B = np.zeros(L, dt)
        self.B[valid] = dt.type(1) / w[valid]
        colsum = np.bincount(b1, weights=cval, minlength=L)
        self.gaps = np.nonzero(colsum == 0)[0]

        # candidates: nonzero raw pixels with d_lo <= d <= maxapart // res,
        # in np.nonzero's row-major order (x, then y)
        c = np.nonzero((d >= self.d_lo) & (d <= self.d_hi))[0]
        key = b1[c] * num + d[c]
        if (np.diff(key) < 0).any():
            c = c[np.argsort(key, kind='stable')]
        self.cx, self.cd, self.cO, self.cICE = b1[c], d[c], ct[c], cval[c]

        tdt = _TORCH[dt]
        P = maxww
        shape = (num + 4 * P, L + 2 * P)
        self._raw = torch.zeros(shape, dtype=tdt, device=self.device)
        self._bal = torch.zeros(shape, dtype=tdt, device=self.device)
        rows = torch.as_tensor(d + 2 * P, device=self.device)
        cols = torch.as_tensor(b1 + P, device=self.device)
        self._raw[rows, cols] = torch.as_tensor(ct, device=self.device)
        self._bal[rows, cols] = torch.as_tensor(cval, device=self.device)
        # EMd[x, x + d] = IR[d] for d >= ww_min and x + d < L
        self._exp = torch.zeros(shape, dtype=tdt, device=self.device)
        for dd in range(ww_min, num):
            self._exp[dd + 2 * P, P:P + L - dd] = float(self.IR[dd])
        self._flat = torch.as_tensor(
            (self.cd - self.d_lo) * L + self.cx, device=self.device)

    def zeros(self):
        """An accumulator over the target diagonals d_lo..d_hi."""
        return torch.zeros((self.d_hi - self.d_lo + 1, self.L),
                           dtype=_TORCH[self.dt], device=self.device)

    def accumulate(self, dst, which, cells, sign=1.0):
        """``dst`` += (or -=) each cell's shifted band, in ``cells`` order
        (the oracle's ``_accumulate``)."""
        src = {'raw': self._raw, 'bal': self._bal, 'exp': self._exp}[which]
        P, nd, L = self.maxww, dst.shape[0], self.L
        for a, b in cells:
            r0 = 2 * P + self.d_lo + b - a
            sl = src[r0:r0 + nd, P + a:P + a + L]
            if sign > 0:
                dst += sl
            else:
                dst -= sl

    def at(self, acc, idx=None):
        """``acc`` at the candidates (all, or those of index array
        ``idx``) as a host array."""
        flat = self._flat if idx is None else self._flat[
            torch.as_tensor(idx, device=self.device)]
        return acc.reshape(-1)[flat].cpu().numpy()

    def free(self):
        del self._raw, self._bal, self._exp, self._flat


def _gap_keep(xi, yi, gaps, s, L):
    """Indices of the pixels whose bins' neighbourhoods hold no gap bin
    (the oracle's ``_gap_filter``, with its exclusive upper bound)."""
    if len(gaps) == 0:
        return np.arange(len(xi))
    G = np.zeros(L + 1, np.int64)
    G[np.asarray(gaps) + 1] = 1
    G = np.cumsum(G)

    def clear(v):
        lo = np.where(v > s, v - s, 0)
        hi = np.where(v + s < L, v + s, L - 1)
        return G[np.maximum(hi, lo)] - G[lo] == 0
    return np.nonzero(clear(xi) & clear(yi))[0]


def _one(dt):
    return dt.type(1)


def _pvalues(O, rv, dt):
    """1 - Poisson(rv).cdf(O) in ``dt`` (the oracle's p)."""
    cdf = poisson(rv).cdf(O)
    return _one(dt) - np.asarray(cdf).astype(dt)


def hiccups(pix, cfg, device, dtype=np.float64):
    """The oracle's ``hiccups`` (callers.py:44-362) on one chromosome's
    pixels ``pix`` = (bin1, bin2, count, weights, L, res); ``cfg`` holds
    the ``HiccupsConfig`` fields.  -> {(x_bp, y_bp): 10-tuple}."""
    b1, b2, ct, w, L, res = pix
    pw, ww = list(cfg['pw']), list(cfg['ww'])
    maxww, sig = int(cfg['maxww']), cfg['siglevel']
    thr = cfg['min_local_reads']
    bd = Band(b1, b2, ct, w, L, res, cfg['maxapart'], maxww, min(ww),
              min(ww), device, dtype)
    dt = bd.dt
    n = bd.cx.size
    p_w = _pw_ww_pairs(pw, ww, maxww)
    flocals = ['K', 'Y']
    bSV = {p: {fl: np.zeros(n, dt) for fl in flocals} for p in pw}
    bEV = {p: {fl: np.zeros(n, dt) for fl in flocals} for p in pw}
    RefIdx = {p: np.arange(n) for p in pw}
    iniNum = {p: n for p in pw}
    totalNum = n
    bS = {fl: bd.zeros() for fl in flocals}
    bE = {fl: bd.zeros() for fl in flocals}
    Reads = bd.zeros()

    limitCompute = False
    last_pi = last_wi = 0
    frozen_w = maxww
    p_min = min(pw)
    for pi, wi in p_w:
        if wi > frozen_w:
            continue
        add_K, sub_K, add_Y, sub_Y, add_R = [], [], [], [], []
        for a in range(-wi, wi + 1):
            for b in range(-wi, wi + 1):
                bgloc = max(abs(a), abs(b))
                if limitCompute:
                    if ((bgloc <= last_wi) and (bgloc > max(pi, last_pi))) or \
                       (bgloc <= min(pi, last_pi)):
                        continue
                positive = ((not limitCompute) or (bgloc > last_wi) or
                            (bgloc > pi and bgloc <= last_pi))
                if (a != 0) and (b != 0) and not _in_P1(a, b, pi) \
                        and not _in_P2(a, b, pi, wi):
                    (add_K if positive else sub_K).append((a, b))
                if _in_P2(a, b, pi, wi):
                    (add_K if positive else sub_K).append((a, b))
                    (add_Y if positive else sub_Y).append((a, b))
                    if (not limitCompute) or (pi == p_min and bgloc > last_wi):
                        add_R.append((a, b))
        bd.accumulate(bS['K'], 'bal', add_K, 1.0)
        bd.accumulate(bE['K'], 'exp', add_K, 1.0)
        bd.accumulate(bS['K'], 'bal', sub_K, -1.0)
        bd.accumulate(bE['K'], 'exp', sub_K, -1.0)
        bd.accumulate(bS['Y'], 'bal', add_Y, 1.0)
        bd.accumulate(bE['Y'], 'exp', add_Y, 1.0)
        bd.accumulate(bS['Y'], 'bal', sub_Y, -1.0)
        bd.accumulate(bE['Y'], 'exp', sub_Y, -1.0)
        bd.accumulate(Reads, 'raw', add_R, 1.0)

        limitCompute = True
        last_pi, last_wi = pi, wi

        RNums = bd.at(Reads, RefIdx[pi])
        EIdx = RefIdx[pi][RNums >= thr]
        Valid_Ratio = EIdx.size / float(iniNum[pi])
        for fl in flocals:
            bSV[pi][fl][EIdx] = bd.at(bS[fl], EIdx)
            bEV[pi][fl][EIdx] = bd.at(bE[fl], EIdx)
        RefIdx[pi] = RefIdx[pi][RNums < thr]
        iniNum[pi] = RefIdx[pi].size
        left_Ratio = iniNum[pi] / float(totalNum)
        if (Valid_Ratio < 0.3) and (wi >= max(ww)):
            frozen_w = wi
        if (left_Ratio < 0.03) and (wi >= max(ww)):
            frozen_w = wi
    del bS, bE, Reads
    bd.free()

    cx, cd, cy = bd.cx, bd.cd, bd.cx + bd.cd
    IRc, B = bd.IR[cd], bd.B
    pixel_table = {}
    for pi, wi in zip(pw, ww):
        xpos, ypos, Ovalues, ICE = {}, {}, {}, {}
        Fold, pvalues, qvalues = {}, {}, {}
        cEM = None
        for fl in flocals:
            Mask = (bEV[pi][fl] != 0) & (cd >= wi)
            ratio = np.zeros(n, dt)
            ratio[Mask] = bSV[pi][fl][Mask] / bEV[pi][fl][Mask]
            cEM = IRc * ratio
            nz = np.nonzero(cEM)[0]
            Evalues = cEM[nz] * B[cx[nz]] * B[cy[nz]]
            Mask = Evalues > 0
            Evalues, nz = Evalues[Mask], nz[Mask]
            Ovalues[fl] = bd.cO[nz]
            ICE[fl] = bd.cICE[nz]
            Fold[fl] = Ovalues[fl] / Evalues

            pvalue = np.ones(nz.size, dt)
            qvalue = np.ones(nz.size, dt)
            for lv, rv, cidx in lambdachunk(Evalues):
                if cidx.size > 0:
                    chunkP = _pvalues(Ovalues[fl][cidx], rv, dt)
                    pvalue[cidx] = chunkP
                    qvalue[cidx] = fdr_bh(chunkP, sig)[1]

            reject = qvalue <= sig
            qvalue, pvalue = qvalue[reject], pvalue[reject]
            Ovalues[fl], ICE[fl] = Ovalues[fl][reject], ICE[fl][reject]
            Fold[fl], nz = Fold[fl][reject], nz[reject]

            fIdx = _gap_keep(cx[nz], cy[nz], bd.gaps, min(ww), bd.L)
            nz = nz[fIdx]
            Ovalues[fl], ICE[fl] = Ovalues[fl][fIdx], ICE[fl][fIdx]
            pvalue, qvalue = pvalue[fIdx], qvalue[fIdx]
            Fold[fl] = Fold[fl][fIdx]

            xpos[fl], ypos[fl] = cx[nz].tolist(), cy[nz].tolist()
            pvalues[fl], qvalues[fl] = pvalue, qvalue

        first = Ovalues['K'] if cfg['use_raw'] else ICE['K']
        preDonuts = dict(zip(zip(xpos['K'], ypos['K']),
                             zip(first.tolist(), Ovalues['K'].tolist(),
                                 Fold['K'].tolist(), pvalues['K'].tolist(),
                                 qvalues['K'].tolist())))
        preLL = dict(zip(zip(xpos['Y'], ypos['Y']),
                         zip(ICE['Y'].tolist(), Ovalues['Y'].tolist(),
                             Fold['Y'].tolist(), pvalues['Y'].tolist(),
                             qvalues['Y'].tolist())))

        commonPos = set(preDonuts) & set(preLL)
        post = sorted(set(preDonuts) - set(preLL))
        if post:
            # cEM still holds the 'Y' expected values (callers.py:329-331);
            # a postcheck pixel is a candidate, found by its row-major key
            keys = cx * bd.L + cy
            at = np.searchsorted(keys, [i * bd.L + j for i, j in post])
            for (ci, cj), k in zip(post, at.tolist()):
                if cEM[k] == 0:
                    commonPos.add((ci, cj))

        for key in commonPos:
            donut = preDonuts[key]
            ll = preLL.get(key, donut)
            bpkey = (key[0] * res, key[1] * res)
            if (donut[2] > cfg['double_fold']) and \
                    (ll[2] > cfg['double_fold']) and \
                    ((donut[2] > cfg['single_fold']) or
                     (ll[2] > cfg['single_fold'])):
                if bpkey not in pixel_table:
                    pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]
                else:
                    if (donut[-1] < pixel_table[bpkey][7]) and \
                            (ll[-1] < pixel_table[bpkey][10]):
                        pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]

    Donuts = {(k[0] // res, k[1] // res): pixel_table[k][3:8]
              for k in pixel_table}
    LL = {(k[0] // res, k[1] // res): pixel_table[k][8:]
          for k in pixel_table}
    peak_list = local_clustering(Donuts, LL, res,
                                 min_count=cfg['min_marginal_peaks'],
                                 r=2 * res, sumq=cfg['sumq'],
                                 onlysummit=cfg['only_anchors'])
    final_table = {}
    for pixel, cen, radius in peak_list:
        key = (pixel[0] * res, pixel[1] * res)
        final_table[key] = (cen[0] * res, cen[1] * res) + (radius * res,) + \
            pixel_table[key][4:]
    return final_table


_BHFDR_THR = 16    # pyBHFDR's fixed local-reads threshold (callers.py:505)


def bhfdr(pix, cfg, device, dtype=np.float64):
    """The oracle's ``bhfdr`` (callers.py:364-590) on one chromosome's
    pixels ``pix`` = (bin1, bin2, count, weights, L, res); ``cfg`` holds
    the ``BHFDRConfig`` fields.  -> {(x_bp, y_bp): 7-tuple}."""
    b1, b2, ct, w, L, res = pix
    pw, ww, maxww = int(cfg['pw']), int(cfg['ww']), int(cfg['maxww'])
    sig = cfg['siglevel']
    bd = Band(b1, b2, ct, w, L, res, cfg['maxapart'], maxww, ww, ww, device,
              dtype)
    dt = bd.dt
    n = bd.cx.size
    bSV = np.zeros(n, dt)
    bEV = np.zeros(n, dt)
    RefIdx = np.arange(n)
    RefMask = np.ones(n, dtype=bool)
    iniNum = totalNum = n
    bS, bE, Reads = bd.zeros(), bd.zeros(), bd.zeros()
    limitCompute = False
    for wi in range(ww, maxww + 1):
        add_bg, add_R = [], []
        for a in range(-wi, wi + 1):
            for b in range(-wi, wi + 1):
                bgloc = max(abs(a), abs(b))
                if limitCompute and (bgloc < wi):
                    continue
                if (a != 0) and (b != 0) and not _in_P1(a, b, pw):
                    add_bg.append((a, b))
                if _in_P2(a, b, pw, wi):
                    add_R.append((a, b))
        limitCompute = True
        bd.accumulate(bS, 'bal', add_bg, 1.0)
        bd.accumulate(bE, 'exp', add_bg, 1.0)
        bd.accumulate(Reads, 'raw', add_R, 1.0)

        RNums = bd.at(Reads, RefIdx)
        EIdx = RefIdx[RNums >= _BHFDR_THR]
        Valid_Ratio = EIdx.size / float(iniNum)
        bSV[EIdx] = bd.at(bS, EIdx)
        bEV[EIdx] = bd.at(bE, EIdx)
        RefIdx = RefIdx[RNums < _BHFDR_THR]
        iniNum = RefIdx.size
        left_Ratio = iniNum / float(totalNum)
        if Valid_Ratio < 0.3:
            break
        if left_Ratio < 0.03:
            break
    del bS, bE, Reads
    bd.free()

    cx, cd, cy = bd.cx, bd.cd, bd.cx + bd.cd
    RefMask[RefIdx] = False
    Mask = (bEV != 0) & RefMask
    ratio = np.zeros(n, dt)
    ratio[Mask] = bSV[Mask] / bEV[Mask]
    cEM = bd.IR[cd] * ratio
    nz = np.nonzero(cEM)[0]
    Evalues = cEM[nz] * bd.B[cx[nz]] * bd.B[cy[nz]]
    Mask = Evalues > 0
    Evalues, nz = Evalues[Mask], nz[Mask]
    Ovalues = bd.cO[nz]
    pvalues = _one(dt) - np.asarray(
        poisson(Evalues).cdf(Ovalues)).astype(dt)
    Fold = Ovalues / Evalues

    reject, qall = fdr_bh(pvalues, sig)
    qall = qall.astype(dt)
    nz = nz[reject]
    pvals, qvals = pvalues[reject], qall[reject]
    Ovals, Folds = Ovalues[reject], Fold[reject]

    fIdx = _gap_keep(cx[nz], cy[nz], bd.gaps, ww, bd.L)
    nz = nz[fIdx]
    pvals, qvals = pvals[fIdx], qvals[fIdx]
    Ovals, Folds = Ovals[fIdx], Folds[fIdx]

    Donuts = dict(zip(zip(cx[nz].tolist(), cy[nz].tolist()),
                      zip(Ovals.tolist(), Folds.tolist(), pvals.tolist(),
                          qvals.tolist())))
    pixel_list = local_clustering(Donuts, None, res,
                                  min_count=cfg['min_marginal_peaks'],
                                  r=2 * res, onlysummit=cfg['only_anchors'])
    pixel_table = {}
    for pixel, cen, radius in pixel_list:
        donut = Donuts[pixel]
        if donut[1] > 2:
            pixel_table[(pixel[0] * res, pixel[1] * res)] = \
                (cen[0] * res, cen[1] * res) + (radius * res,) + donut
    return pixel_table

