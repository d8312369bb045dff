"""producer_wait_pct.genome: the share of the traced genome window outside
every ``Chrom:<label>`` span, which ``api._run`` opens around each
chromosome's call: the consumer is then waiting on the prefetch thread's
queue (the cooler read, the band build and the staging)."""


def read(run):
    t = run.trace
    if t is None or not t.window or not t.mark_spans('Chrom:'):
        return None
    return 100.0 * t.uncovered_us('Chrom:') / t.window_us
