"""exact_stats_ms.call: host time per call of the float64 recomputation
of the kept pixels' statistics (ring sums, freeze entries, background
sums, E and Fold), in ms: the program's ``hicpeaks.exact_stats`` spans
around ``ops/hostexact.exact_stats``, summed over the traced window."""
from portbench.stages import per_call, summed_ms


def read(run):
    return per_call(run, 'hicpeaks.exact_stats', summed_ms)
