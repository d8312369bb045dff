"""sync_wait_ms.call: host time per call blocked on the card's reads, in
ms: the program's ``hicpeaks.sync`` spans, summed over the traced
window."""
from portbench.stages import SYNC, per_call, summed_ms


def read(run):
    return per_call(run, SYNC, summed_ms)
