"""Benjamini-Hochberg FDR correction, equivalent to
``statsmodels.stats.multitest.multipletests(method='fdr_bh')`` which the
reference imports (callers.py:11).  statsmodels is not available in this
environment, so the oracle carries its own implementation.  The reject set
``{p : q <= alpha}`` is mathematically identical to the step-up rule."""
import numpy as np


def fdr_bh(pvals, alpha=0.05):
    pvals = np.asarray(pvals, dtype=np.float64)
    n = pvals.size
    if n == 0:
        return np.zeros(0, bool), np.zeros(0)
    order = np.argsort(pvals, kind='stable')
    ranked = pvals[order] * n / np.arange(1, n + 1)
    q_sorted = np.minimum(1.0, np.minimum.accumulate(ranked[::-1])[::-1])
    qvals = np.empty(n)
    qvals[order] = q_sorted
    reject = qvals <= alpha
    return reject, qvals
