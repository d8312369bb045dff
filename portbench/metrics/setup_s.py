"""setup_s: seconds from the process's start to the first timed call:
imports, the CUDA context, the kernels' build (the first run of a
checkout), the synthesis, the band build or cooler write, and the warm-up
call (host clock)."""


def read(run):
    return run.setup_s
