"""score_fused.call: how often per call the batched pyHICCUPS scorer ran
its dense stages as the fused kernels (``csrc/score_fused.cu``): the
number of the program's ``hicpeaks.score_fused`` spans in the traced
window, one a call where the kernels engage, none where the eager torch
chain scores.  A program without that span reads nothing."""
from portbench.stages import per_call, stage_marks

SPAN = 'hicpeaks.score_fused'


def read(run):
    if not any(n == SPAN for _, _, n in stage_marks(run.trace)):
        return None
    return per_call(run, SPAN, len)
