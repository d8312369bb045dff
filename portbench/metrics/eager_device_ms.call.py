"""eager_device_ms.call: device time per call of every kernel but the three
hand-written ones (the sheets and scorers' eager torch ops), in ms, from
the trace; copies and memsets are left out."""
from portbench.trace import is_hand_written


def read(run):
    t = run.trace
    if t is None or not t.device or not run.walls:
        return None
    return t.device_us(lambda e: e.get('cat') == 'kernel'
                       and not is_hand_written(e)) / 1e3 / len(run.walls)
