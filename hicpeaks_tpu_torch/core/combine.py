"""Multi-resolution peak combination (controller-side).

The port's copy of ``hicpeaks_tpu/core/combine.py``.

Output-set-parity re-implementation of the reference's pairwise
confirmation scheme (semantics from utilities.py:469-552, proven
equivalent by tests/test_combine_adversarial.py against a literal
transcription).  The rules:

* Resolutions are walked pairwise, finer vs coarser, in ascending order.
  A fine peak is *confirmed* when any coarse peak's (start1, start2)
  anchor lies within a Euclidean matching radius: ``2*max_res`` when both
  resolutions are finer than that, else ``5*max_res``.  Confirmation
  marks every matching coarse peak redundant.
* An unconfirmed fine peak survives only when its resolution is
  printable (``<= max_res``) and either trustworthy on its own
  (``>= good_res``) or short-range (span ``<= mindis``).
* Peaks already marked redundant are skipped when they later appear on
  the fine side (the redundancy record is dynamic across pairs).
* The coarsest list gets the same unconfirmed-survival filter at the end;
  a single-resolution input passes straight through.

Idiom difference from the reference: distances are computed once per
(resolution-pair, chromosome) as a dense [fine, coarse] matrix instead of
one scipy ``distance_matrix`` call per fine peak; the confirmation walk
then just indexes rows.  Peak tables are small (1e2-1e4), so this stays
on the host.
"""
from __future__ import annotations

import numpy as np


def _key(chrom, peak):
    """Canonical output record: (chrom, s1, e1, chrom, s2, e2)."""
    return (chrom,) + tuple(peak[:2]) + (chrom,) + tuple(peak[2:])


def _survives_unconfirmed(res, peak, good_res, mindis, max_res):
    return res <= max_res and (res >= good_res or peak[2] - peak[0] <= mindis)


def _anchor_array(peaks):
    """[n, 2] array of (start1, start2) anchors."""
    return np.asarray([(p[0], p[2]) for p in peaks], dtype=np.float64)


def combine_annotations(byres, good_res=10000, mindis=100000, max_res=10000):
    if len(byres) == 1:
        return [_key(c, p)
                for r in byres for c in byres[r] for p in byres[r][c]]

    reslist = sorted(byres)
    kept = set()
    redundant = set()

    for i, fine_res in enumerate(reslist[:-1]):
        fine = byres[fine_res]
        for coarse_res in reslist[i + 1:]:
            coarse = byres[coarse_res]
            both_fine = fine_res < 2 * max_res and coarse_res < 2 * max_res
            radius = 2 * max_res if both_fine else 5 * max_res
            for c, fine_peaks in fine.items():
                coarse_peaks = coarse.get(c, [])
                if coarse_peaks:
                    # one [fine, coarse] anchor-distance matrix per chrom
                    fa = _anchor_array(fine_peaks)
                    ca = _anchor_array(coarse_peaks)
                    d2 = ((fa[:, None, :] - ca[None, :, :]) ** 2).sum(-1)
                    match = d2 <= float(radius) ** 2
                for n, p in enumerate(fine_peaks):
                    key = _key(c, p)
                    if key in redundant:
                        continue
                    hits = np.nonzero(match[n])[0] if coarse_peaks else ()
                    if len(hits):
                        kept.add(key)
                        redundant.update(
                            _key(c, coarse_peaks[h]) for h in hits)
                    elif _survives_unconfirmed(fine_res, p, good_res,
                                               mindis, max_res):
                        kept.add(key)

    coarsest = reslist[-1]
    for c, peaks in byres[coarsest].items():
        for p in peaks:
            key = _key(c, p)
            if key not in redundant and _survives_unconfirmed(
                    coarsest, p, good_res, mindis, max_res):
                kept.add(key)
    return sorted(kept)
