"""host_completions.call: float64 completions per call that ran on the
host: the number of the program's ``hicpeaks.host_complete`` spans in the
traced window (``core/hostcomplete``'s ``_compact_to_host``,
``_bhfdr_to_host`` and ``_dense_to_host``).  On pyHICCUPS's batched route
it counts how often the device completion was bypassed: one a background
where the host completes, none where the device does, unless an audit
sends a background to the dense scorer."""
from portbench.stages import per_call


def read(run):
    return per_call(run, 'hicpeaks.host_complete', len)
