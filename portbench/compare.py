"""How far a caller's peak table lies from the reference's.

One number, the table's gap, decides a table: the worst over every locus
of either table.  A locus present in only one table, or whose centroid or
radius differs, has the gap 1, the most a gap can be.  Otherwise its gap
is the largest relative difference of its statistics (O, Fold, p, q; pyHICCUPS has a second Fold,
p and q for the lower-left background).  Where the reference's p lies
below :data:`P_FLOOR`, its ``1 - poisson.cdf`` is float64 cancellation
noise (multiples of 2^-53, which q carries up): there the program's p
must lie below ``10 * P_FLOOR`` (else the gap is 1), and that p and its
q are not compared.  This is ``chip_smoke.py``'s ``compare_to_oracle``
folded into one number.
"""
from __future__ import annotations

import numpy as np

P_FLOOR = 1e-12


def locus_gap(got, want):
    """The gap of one locus whose rows ``got`` and ``want`` are (cen_x,
    cen_y, radius, O, Fold, p, q[, FoldY, pY, qY])."""
    if tuple(got[:3]) != tuple(want[:3]) or len(got) != len(want):
        return 1.0
    g = np.asarray(got[3:], np.float64)
    v = np.asarray(want[3:], np.float64)
    compared = np.ones(len(v), bool)
    for ip in (2, 5)[:len(v) // 3]:
        if v[ip] < P_FLOOR:
            if not g[ip] < 10 * P_FLOOR:
                return 1.0
            compared[ip:ip + 2] = False
    with np.errstate(invalid='ignore', divide='ignore'):
        rel = np.abs(g - v)[compared] / np.abs(v[compared])
    rel = np.where(g[compared] == v[compared], 0.0, rel)
    if np.isnan(rel).any():
        return 1.0
    return min(float(rel.max(initial=0.0)), 1.0)


def table_gap(got, want):
    """(gap, locus) of the worst locus of tables ``got`` and ``want``
    ({(x_bp, y_bp): row}); (0.0, None) for two empty tables."""
    worst, where = 0.0, None
    for key in set(got) | set(want):
        if key not in got or key not in want:
            gap = 1.0
        else:
            gap = locus_gap(got[key], want[key])
        if gap > worst or where is None:
            worst, where = gap, key
    return worst, where


def genome_gap(got, want):
    """(gap, (chromosome, locus)) over every chromosome of two genome
    tables ({label: table}); a chromosome in only one of them has the
    gap 1."""
    worst, where = 0.0, None
    for label in sorted(set(got) | set(want)):
        if label not in got or label not in want:
            return 1.0, (label, None)
        gap, key = table_gap(got[label], want[label])
        if gap > worst or where is None:
            worst, where = gap, (label, key)
    return worst, where
