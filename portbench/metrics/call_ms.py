"""call_ms: the window divided by the calls it completed, in ms (host
clock); each call ends in the host table."""


def read(run):
    if not run.walls:
        return None
    return 1e3 * run.window_s / len(run.walls)
