"""The benchmark's frozen contact generator.

``synthesize_chrom`` is a copy of ``hicpeaks_tpu_torch/io/synth.py``'s,
kept here so that a change to the program's I/O cannot change the
benchmark's inputs: power-law distance decay, multiplicative per-bin
coverage biases, gap regions, and planted loops, drawn from one seed,
pixel by pixel, on the diagonals the callers read.  :func:`far_pixels`
continues the same decay out to the chromosome's end and
:func:`trans_pixels` adds the contacts between chromosomes, both drawn
contact by contact, since almost every pixel there holds one contact or
none.  :func:`weights` is the ICE-style weight the benchmark gives the
callers in place of balancing (``w = 1/bias``, NaN at gap bins), as
``chip_smoke.py``'s ``synth_bands`` does, and :func:`chrom_pixels` draws
one chromosome of a configuration.
"""
from __future__ import annotations

import numpy as np


def synthesize_chrom(n_bins=1000, res=25000, n_loops=30, seed=0,
                     depth=6.0, decay=0.85, gap_frac=0.02,
                     loop_strength=4.0, max_loop_span_bins=80):
    """Return (bin1, bin2, count, truth_loops) for one chromosome.

    counts are Poisson draws around ``depth * (1+d)^-decay * b[x] * b[y]``
    with ``loop_strength``-fold enrichment at planted loop pixels.
    Only the upper triangle (bin1 <= bin2) is emitted, matching the
    3-column TXT format of the reference (README.rst:148-163).
    """
    rng = np.random.default_rng(seed)
    bias = np.exp(rng.normal(0.0, 0.35, size=n_bins))
    gap_start = rng.integers(0, n_bins, size=max(1, int(n_bins * gap_frac / 4)))
    gaps = np.zeros(n_bins, dtype=bool)
    for g in gap_start:
        gaps[g:g + 4] = True
    bias[gaps] = 0.0

    loops = []
    tries = 0
    while len(loops) < n_loops and tries < n_loops * 50:
        tries += 1
        x = int(rng.integers(0, n_bins - 10))
        d = int(rng.integers(8, max_loop_span_bins))
        y = x + d
        if y >= n_bins or gaps[x] or gaps[y]:
            continue
        if any(abs(x - a) < 5 and abs(y - b) < 5 for a, b in loops):
            continue
        loops.append((x, y))

    # banded expected model; keep the band comfortably wider than any
    # maxapart/maxww the tests use.
    max_d = min(n_bins, max_loop_span_bins + 64)
    rows = []
    for d in range(max_d):
        xs = np.arange(n_bins - d)
        lam = depth * (1.0 + d) ** (-decay) * bias[xs] * bias[xs + d]
        rows.append(lam)

    for (x, y) in loops:
        d = y - x
        if d < max_d:
            # a blurred enrichment footprint around the loop pixel
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    xi, yi = x + dx, y + dy
                    dd = yi - xi
                    if 0 <= xi and 0 < dd < max_d and xi < n_bins - dd:
                        f = loop_strength if (dx == 0 and dy == 0) else 1.8
                        rows[dd][xi] *= f

    b1_list, b2_list, ct_list = [], [], []
    for d in range(max_d):
        lam = rows[d]
        cnt = rng.poisson(lam)
        nz = np.nonzero(cnt)[0]
        b1_list.append(nz)
        b2_list.append(nz + d)
        ct_list.append(cnt[nz])
    bin1 = np.concatenate(b1_list)
    bin2 = np.concatenate(b2_list)
    count = np.concatenate(ct_list)
    order = np.lexsort((bin2, bin1))
    return bin1[order], bin2[order], count[order], loops, bias


def weights(bias):
    """The weight column a balanced cooler would hold for ``bias``:
    ``1 / bias``, NaN where the bias is 0 (gap bins)."""
    w = np.full(len(bias), np.nan)
    ok = bias > 0
    w[ok] = 1.0 / bias[ok]
    return w


def chrom_seed(seed, index, part=0):
    """The generator seed of part ``part`` (0: the band, 1: the cis
    contacts beyond it) of chromosome ``index`` of a run seeded with
    ``seed``, or with ``index=None`` of the trans contacts: any whole
    number, negative or above 64 bits included."""
    if index is None:
        return [int(seed) % (1 << 64), 2]
    return [int(seed) % (1 << 64), int(index)] + ([part] if part else [])


def band_span(synthesis, n_bins):
    """The diagonals ``synthesize_chrom`` draws pixel by pixel."""
    return min(n_bins, int(synthesis['max_loop_span_bins']) + 64)


def chrom_pixels(synthesis, n_bins, res, seed, index):
    """(bin1, bin2, count, weights, bias) of the band of chromosome
    ``index`` of ``n_bins`` bins (diagonals below :func:`band_span`),
    drawn with a configuration's ``synthesis`` parameters: ``depth``,
    ``decay``, ``bins_per_loop`` and ``max_loop_span_bins``."""
    b1, b2, ct, _, bias = synthesize_chrom(
        n_bins=n_bins, res=res, seed=chrom_seed(seed, index),
        depth=float(synthesis['depth']), decay=float(synthesis['decay']),
        n_loops=n_bins // int(synthesis['bins_per_loop']),
        max_loop_span_bins=int(synthesis['max_loop_span_bins']))
    return b1, b2, ct, weights(bias), bias


def _sorted_pixels(b1, b2, n):
    """(bin1, bin2, count) of contacts at (b1, b2), merged by pixel and
    sorted by (bin1, bin2); ``n`` bounds the bin ids."""
    key, count = np.unique(b1 * np.int64(n) + b2, return_counts=True)
    return key // n, key % n, count.astype(np.int64)


def far_pixels(synthesis, bias, seed, index):
    """(bin1, bin2, count) of chromosome ``index``'s cis contacts from
    :func:`band_span` out to its end, with bias ``bias`` from
    :func:`chrom_pixels`.  A pixel ``(i, i + d)`` holds a Poisson count of
    mean ``depth * (1 + d)^-decay * bias[i] * m`` (``m`` the mean bias of
    the bins outside gaps; none at a gap bin): the band's decay with the
    upper end's bias taken at its mean.  Drawn contact by contact: a
    Poisson total, each contact's distance by the decay times the bias of
    the rows that reach it, its lower bin by its bias."""
    L = len(bias)
    start = band_span(synthesis, L)
    if start >= L:
        return (np.zeros(0, np.int64),) * 3
    rng = np.random.default_rng(chrom_seed(seed, index, 1))
    ok = bias > 0
    cum = np.concatenate([[0.0], np.cumsum(bias)])  # cum[k] = bias[:k].sum()
    dist = np.arange(start, L)
    mass = (1.0 + dist) ** -float(synthesis['decay']) * cum[L - dist]
    total = float(synthesis['depth']) * bias[ok].mean() * mass.sum()
    n = rng.poisson(total)
    cmass = np.cumsum(mass)
    d = dist[np.minimum(np.searchsorted(cmass, rng.random(n) * cmass[-1],
                                        side='right'), len(dist) - 1)]
    lo = np.searchsorted(cum, rng.random(n) * cum[L - d], side='right') - 1
    keep = ok[lo + d]
    return _sorted_pixels(lo[keep], lo[keep] + d[keep], L)


def trans_pixels(biases, contacts, seed):
    """(bin1, bin2, count) of the contacts between chromosomes, bin ids
    over the chromosomes of ``biases`` (one bias array each, from
    :func:`chrom_pixels`) laid end to end: a Poisson total of mean
    ``contacts``, each contact's two ends drawn by their bias and kept
    when they lie on different chromosomes, so that a pixel's mean is
    proportional to the product of its two biases."""
    rng = np.random.default_rng(chrom_seed(seed, None))
    bias = np.concatenate(biases)
    chrom = np.repeat(np.arange(len(biases)), [len(b) for b in biases])
    cum = np.concatenate([[0.0], np.cumsum(bias)])
    n = rng.poisson(float(contacts))
    ends, have = [], 0
    while have < n:
        m = int((n - have) * 1.15) + 1024
        a, b = (np.searchsorted(cum, rng.random(m) * cum[-1], side='right')
                - 1 for _ in range(2))
        keep = chrom[a] != chrom[b]
        a, b = a[keep], b[keep]
        ends.append((np.minimum(a, b), np.maximum(a, b)))
        have += len(a)
    lo = np.concatenate([e[0] for e in ends])[:n]
    hi = np.concatenate([e[1] for e in ends])[:n]
    return _sorted_pixels(lo, hi, len(bias))
