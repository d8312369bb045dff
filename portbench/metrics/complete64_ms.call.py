"""complete64_ms.call: host time per call of pyHICCUPS's float64 completion
on the device, in ms: the program's ``hicpeaks.complete64`` spans around
``core/complete64.complete_on_device`` (the kernel, the BH tables, the
audit and the two reads), summed over the traced window.  A program
without that span reads nothing."""
from portbench.stages import per_call, stage_marks, summed_ms

SPAN = 'hicpeaks.complete64'


def read(run):
    if not any(n == SPAN for _, _, n in stage_marks(run.trace)):
        return None
    return per_call(run, SPAN, summed_ms)
