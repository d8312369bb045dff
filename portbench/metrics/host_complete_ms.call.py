"""host_complete_ms.call: host time per call of the float64 completion, in
ms: the benchmark's span around the engine's ``_compact_to_host`` and
``_bhfdr_to_host`` (host clock, traced runs only)."""


def read(run):
    total = run.spans.get('host_complete')
    if total is None or not run.walls:
        return None
    return 1e3 * total[0] / len(run.walls)
