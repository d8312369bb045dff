"""pair_merge_ms.call: host time per call of pyHICCUPS's cross-pair merge,
in ms: the program's ``hicpeaks.pair_merge`` spans, one a (pw, ww) pair
in ``core/engine._merge_pairs`` (its dicts, postcheck gather and fold
gates with the best-q replacement), summed over the traced window.  A
program without that span reads nothing."""
from portbench.stages import per_call, stage_marks, summed_ms

SPAN = 'hicpeaks.pair_merge'


def read(run):
    if not any(n == SPAN for _, _, n in stage_marks(run.trace)):
        return None
    return per_call(run, SPAN, summed_ms)
