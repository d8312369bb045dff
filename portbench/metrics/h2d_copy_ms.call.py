"""h2d_copy_ms.call: device time of the host-to-device copies per call, in
ms, from the trace (``Memcpy HtoD`` events)."""


def read(run):
    t = run.trace
    if t is None or not t.device or not run.walls:
        return None
    return t.device_us(lambda e: e.get('cat') == 'gpu_memcpy'
                       and 'HtoD' in e['name']) / 1e3 / len(run.walls)
