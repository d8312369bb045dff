"""Synthetic Hi-C data generation.

The port's copy of ``hicpeaks_tpu/io/synth.py``, trimmed to the
single-resolution generator, the TXT writer and the cooler writer.

The reference validates against a bundled K562 chr21 25Kb matrix
(example/25K/21_21.txt per README.rst:119-163) which is absent from this
snapshot.  This module synthesizes statistically similar single-chromosome
contact maps — power-law distance decay, multiplicative per-bin coverage
biases, gap regions, and planted loop anchors — so the test-pyramid and
benchmarks have deterministic inputs of the right shape.
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


def write_txt(path, bin1, bin2, count):
    """3-column ``bin1 bin2 IF`` TXT, the reference ingestion format
    (README.rst:148-163)."""
    arr = np.column_stack([bin1, bin2, count])
    np.savetxt(path, arr, fmt='%d')


def synthetic_cooler(path, n_bins=1000, res=25000, chrom='21', seed=0,
                     with_weights=True, **kw):
    """Build a single-chromosome cooler file directly (skipping TXT I/O).

    With ``with_weights`` the generator's own coverage biases are written as
    an ICE-style ``bins/weight`` column (w = 1/bias, NaN at gap bins), so
    caller tests do not depend on the balancing subsystem.
    """
    from .coolerlite import CoolerLite, create_cooler_file, binnify
    bin1, bin2, count, loops, bias = synthesize_chrom(
        n_bins=n_bins, res=res, seed=seed, **kw)
    chromsizes = {chrom: n_bins * res}
    bins = binnify(chromsizes, res)
    uri = f'{path}::{res}'
    create_cooler_file(uri, bins,
                       [{'bin1_id': bin1, 'bin2_id': bin2, 'count': count}],
                       metadata={'onlyIntra': 'True'})
    if with_weights:
        w = np.full(n_bins, np.nan)
        ok = bias > 0
        w[ok] = 1.0 / bias[ok]
        CoolerLite(uri).write_weights(w)
    return uri, loops
