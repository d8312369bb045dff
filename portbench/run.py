"""Run one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout: set-up, the measured window, the check of
every answer against the plain reference, and one JSON result line
(``harness.main``).  It needs a CUDA card and exits with 2 without one.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths (the
# program's own nvcc and host builds go to build/kernels and build/host)
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = os.path.join(ROOT, 'build', 'portbench', sub)
sys.path.insert(0, ROOT)

if __name__ == '__main__':
    from portbench.harness import main
    sys.exit(main(t_start=T_START))
