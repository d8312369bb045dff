"""device_idle_pct.genome: the device's idle share of the traced
window, in %: 100 less the share in which it ran a kernel, a copy or a
memset (the union of their intervals, from the trace)."""


def read(run):
    t = run.trace
    if t is None or not t.window or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
