"""anchors_ms.call: host time per call of the clustering's anchor stage,
in ms: the program's ``hicpeaks.anchors`` spans inside
``core/clustering.local_clustering``, two a call (the anchors on both
axes; the singleton pass, which only-anchors gates on their summits),
summed over the traced window.  A program without that span reads
nothing."""
from portbench.stages import per_call, stage_marks, summed_ms

SPAN = 'hicpeaks.anchors'


def read(run):
    if not any(n == SPAN for _, _, n in stage_marks(run.trace)):
        return None
    return per_call(run, SPAN, summed_ms)
