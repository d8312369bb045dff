"""genome_s: the window divided by the genome calls it completed, in s
(host clock); the last call ends the window."""


def read(run):
    if not run.walls:
        return None
    return run.window_s / len(run.walls)
