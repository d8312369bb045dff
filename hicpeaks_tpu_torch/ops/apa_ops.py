"""Aggregate Peak Analysis: the window stage as torch ops on a device, the
scoring on the host.

The port of ``hicpeaks_tpu/ops/apa_ops.py`` and of the float64 host window
stage of ``hicpeaks_tpu/cli/apa.py``.  One gather takes every (2w+1)^2
window from the chromosome's upper band (replacing the reference's
per-loop dense slicing, hicpeaks/apa.py:11-28); each window is then divided
by its own mean (apa.py:16-26).

The reference's 1/99-percentile trim (apa.py:33-35) compares window means
that are all close to 1.0, so which windows survive is decided at the last
ulp.  The window means here are therefore numpy's pairwise sum
(``np.add.reduce`` over the 121 cells of an 11 x 11 window) written out
add for add in its order (:func:`pairwise_sum`), then divided by the cell
count: every other step is a copy, an exact compare, a product in the
reference's order or an IEEE division, so the windows on any device are
bit-identical to the float64 numpy path (:func:`apa_windows_host`).
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import ndtr


def band_window_gather(band, xs, ys, w):
    """windows[k, i, j] = M[xs[k]-w+i, ys[k]-w+j] from the symmetric matrix
    stored as an upper band [num, L]: M[a, b] = band[|b-a|, min(a, b)];
    cells off the band or the matrix are 0."""
    num_p, Lp = band.shape
    off = torch.arange(-w, w + 1, device=band.device)
    a = xs[:, None, None] + off[None, :, None]
    b = ys[:, None, None] + off[None, None, :]
    d = torch.abs(b - a)
    x = torch.minimum(a, b)
    valid = (a >= 0) & (b >= 0) & (x < Lp) & (d < num_p)
    dd = torch.clamp(d, 0, num_p - 1)
    xx = torch.clamp(x, 0, Lp - 1)
    return torch.where(valid, band[dd, xx], 0.0)


def pairwise_sum(a):
    """Each row's sum of a [k, n] tensor in numpy's pairwise order
    (``pairwise_sum`` of numpy's add loops), add for add: below 8 cells a
    running sum from 0; up to 128, eight strided accumulators over the
    first n - n % 8 cells, combined as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)),
    then the rest one by one; above 128, the sums of the halves, the first
    half cut to a multiple of 8."""
    n = a.shape[1]
    if n < 8:
        res = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        m = n - n % 8
        r = a[:, :8]
        for i in range(8, m, 8):
            r = r + a[:, i:i + 8]
        r = r[:, 0::2] + r[:, 1::2]
        r = r[:, 0::2] + r[:, 1::2]
        res = r[:, 0] + r[:, 1]
        for i in range(m, n):
            res = res + a[:, i]
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return pairwise_sum(a[:, :n2]) + pairwise_sum(a[:, n2:])


def apa_windows(band, nanband, xs, ys, w, L):
    """Per-loop normalized windows plus their validity, mirroring
    apa.py:16-26: windows fully inside the matrix, no NaN cells, nonzero
    mean; each window divided by its own mean.  float64 tensors on one
    device in, (norm [k, 2w+1, 2w+1], ok [k], means [k]) out."""
    wins = band_window_gather(band, xs, ys, w)
    nanwins = band_window_gather(nanband, xs, ys, w)
    inside = (xs - w >= 0) & (ys - w >= 0) & (xs + w + 1 <= L) & \
        (ys + w + 1 <= L)
    has_nan = (nanwins != 0).flatten(1).any(dim=1)
    flat = wins.reshape(wins.shape[0], -1)
    sums = pairwise_sum(flat)
    # a tensor divisor: CUDA divides by a host scalar as a product with its
    # reciprocal, which is not IEEE division
    means = sums / torch.full_like(sums, flat.shape[1])
    ok = inside & ~has_nan & (means != 0)
    norm = wins / torch.where(means == 0, 1.0, means)[:, None, None]
    return norm, ok, means


def apa_band(b1, b2, ct, weights, L, num, device):
    """The chromosome's upper band [num, L] and its NaN mask, float64 on
    ``device``, from its pixel columns (chromosome-local bins, b1 <= b2):
    band[b2 - b1, b1] = ct * w[b1] * w[b2] in that product order, with
    NaN products stored as 0 and flagged in the mask; pixels at distance
    num or more are left out.  ``weights`` None keeps the raw counts."""
    b1 = torch.as_tensor(np.asarray(b1, np.int64), device=device)
    b2 = torch.as_tensor(np.asarray(b2, np.int64), device=device)
    vals = torch.as_tensor(np.asarray(ct), device=device).to(torch.float64)
    d = b2 - b1
    keep = d < num
    d, b1, b2, vals = d[keep], b1[keep], b2[keep], vals[keep]
    band = torch.zeros((num, L), dtype=torch.float64, device=device)
    nanband = torch.zeros_like(band)
    if weights is not None:
        w = torch.as_tensor(np.asarray(weights, np.float64), device=device)
        scaled = vals * w[b1] * w[b2]
        nan = torch.isnan(scaled)
        nanband[d, b1] = nan.to(torch.float64)
        vals = torch.where(nan, 0.0, scaled)
    band[d, b1] = vals
    return band, nanband


def chrom_windows(pixels, weights, L, pos, w, device):
    """The kept, mean-normalized windows of one chromosome at the bin pairs
    ``pos``, as a float64 numpy array [k, 2w+1, 2w+1]: its pixel columns
    (b1, b2, count, chromosome-local) and weights (None for raw counts)
    go to ``device``, the band is built and gathered there.

    JAX's CLI builds the band of every stored diagonal plus w + 2; only
    the diagonals a window can read are built here, max |y - x| over
    ``pos`` plus 2w + 2 at most, which leaves every gathered cell and
    validity decision as it was."""
    b1, b2, ct = pixels
    d = b2 - b1
    num = int(d.max()) + w + 2 if d.size else w + 2
    reach = max(abs(y - x) for x, y in pos) + 2 * w + 2
    band, nanband = apa_band(b1, b2, ct, weights, L, min(num, reach), device)
    xs = torch.tensor([p[0] for p in pos], dtype=torch.int64, device=device)
    ys = torch.tensor([p[1] for p in pos], dtype=torch.int64, device=device)
    norm, ok, _ = apa_windows(band, nanband, xs, ys, w, L)
    return norm[ok].cpu().numpy()


def apa_windows_host(band, nanband, xs, ys, w, L):
    """The plain version: the float64 numpy window stage of the JAX
    apa-analysis CLI (hicpeaks_tpu/cli/apa.py:143-161) on numpy bands;
    returns the kept windows, each divided by its mean."""
    num = band.shape[0]
    xs = np.asarray(xs)[:, None, None]
    ys = np.asarray(ys)[:, None, None]
    off = np.arange(-w, w + 1)
    a = xs + off[None, :, None]
    b = ys + off[None, None, :]
    dd = np.abs(b - a)
    xx = np.minimum(a, b)
    valid = (a >= 0) & (b >= 0) & (xx < L) & (dd < num)
    wins = np.where(valid, band[np.clip(dd, 0, num - 1),
                                np.clip(xx, 0, L - 1)], 0.0)
    nanwins = np.where(valid, nanband[np.clip(dd, 0, num - 1),
                                      np.clip(xx, 0, L - 1)], 0.0)
    inside = ((xs[:, 0, 0] - w >= 0) & (ys[:, 0, 0] - w >= 0) &
              (xs[:, 0, 0] + w + 1 <= L) & (ys[:, 0, 0] + w + 1 <= L))
    means = wins.mean(axis=(1, 2))
    ok = inside & (nanwins.sum(axis=(1, 2)) == 0) & (means != 0)
    return wins[ok] / means[ok][:, None, None]


def apa_analysis(apa_stack, w=5, cw=3):
    """Score the stacked windows (reference apa.py:30-46): trim windows
    whose mean normalized value is outside the 1-99 percentile band, then
    APA score = center / lower-left corner mean, z/p against the corner
    distribution, and the conventional vmax heuristic.  numpy on the
    host."""
    apa_stack = np.asarray(apa_stack)
    mean_arr = apa_stack.mean(axis=(1, 2))
    p99 = np.percentile(mean_arr, 99)
    p1 = np.percentile(mean_arr, 1)
    mask = (mean_arr < p99) & (mean_arr > p1)
    avg = apa_stack[mask].mean(axis=0)
    lowerpart = avg[-cw:, :cw]
    upperpart = avg[:cw, -cw:]
    maxi = upperpart.mean() * 5
    score = avg[w, w] / lowerpart.mean()
    z = (avg[w, w] - lowerpart.mean()) / lowerpart.std()
    p = 1 - ndtr(z)
    return avg, score, z, p, maxi
