"""qtab64_ms.call: host time per call of the float64 (chunk, count) BH
tables, in ms: the program's ``hicpeaks.qtab64`` spans around
``core/hostcomplete.host_chunk_qtab64``, summed over the traced window."""
from portbench.stages import per_call, summed_ms


def read(run):
    return per_call(run, 'hicpeaks.qtab64', summed_ms)
