"""idle_unmarked_pct.call: the device's idle time that no stage of the
program explains, in % of all its idle time in the traced window: idle
moments whose innermost ``hicpeaks.*`` span is ``hicpeaks.call`` itself,
or that lie outside every ``hicpeaks.*`` span (between calls)."""
from portbench.stages import CALL, idle_by_stage, stage_marks
from portbench.trace import OUTSIDE


def read(run):
    t = run.trace
    if not stage_marks(t) or not t.window or not t.device:
        return None
    by = idle_by_stage(t)
    idle = sum(by.values())
    if idle <= 0:
        return None
    return 100.0 * (by.get(CALL, 0.0) + by.get(OUTSIDE, 0.0)) / idle
