"""clustering_ms.call: host time per call of the clustering, in ms: the
benchmark's span around the engine's ``local_clustering`` (host clock,
traced runs only)."""


def read(run):
    total = run.spans.get('clustering')
    if total is None or not run.walls:
        return None
    return 1e3 * total[0] / len(run.walls)
