"""The port's boundary: hicpeaks_tpu_torch (engines, API, CLI) never
imports JAX (nor h5py on the engine path), and a CUDA request on a machine
without CUDA raises instead of running on the CPU.

The import check runs in a subprocess, because this test session has
imported JAX already (tests/conftest.py)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent('''
    import sys
    import numpy as np
    import hicpeaks_tpu_torch
    import hicpeaks_tpu_torch.api
    import hicpeaks_tpu_torch.cli.peakcall
    from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu.ops.band import build_bands
    from hicpeaks_tpu_torch.core.engine import bhfdr_chrom, hiccups_chrom
    from hicpeaks_tpu_torch.hostio import synthesize_chrom, write_bhfdr_bedpe

    res, L, maxapart, maxww = 10000, 600, 300000, 10
    num = maxapart // res + maxww + 1
    b1, b2, ct, _, bias = synthesize_chrom(n_bins=L, res=res, seed=0,
                                           depth=40.0, n_loops=30,
                                           max_loop_span_bins=num - 12)
    w = np.full(L, np.nan)
    w[bias > 0] = 1.0 / bias[bias > 0]
    bands = build_bands(b1, b2, ct, w, L, num, 5, res)
    table = hiccups_chrom(bands, HiccupsConfig(maxapart=maxapart),
                          device='cpu')
    btable = bhfdr_chrom(bands, BHFDRConfig(maxapart=maxapart), device='cpu')
    write_bhfdr_bedpe(sys.stderr, '1', res, btable)
    print(len(table), len(btable), 'jax' in sys.modules,
          'h5py' in sys.modules)
''')


def test_port_never_imports_jax_or_h5py():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _PROBE], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_peaks, n_bhfdr, has_jax, has_h5py = proc.stdout.split()
    assert int(n_peaks) > 0 and int(n_bhfdr) > 0
    assert (has_jax, has_h5py) == ('False', 'False')


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the refusal path needs none')
    from hicpeaks_tpu.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu.ops.band import build_bands
    from hicpeaks_tpu_torch.core.engine import bhfdr_chrom, hiccups_chrom
    from hicpeaks_tpu_torch.ops import cuda_hist, cuda_scan

    rng = np.random.default_rng(0)
    L, num = 200, 40
    b1 = rng.integers(0, L - num, 3000)
    b2 = b1 + rng.integers(0, num, 3000)
    bands = build_bands(b1, b2, np.ones(3000), np.ones(L), L, num, 5, 10000)
    with pytest.raises(RuntimeError, match='CUDA'):
        hiccups_chrom(bands, HiccupsConfig(maxapart=300000), device='cuda')
    with pytest.raises(RuntimeError, match='CUDA'):
        bhfdr_chrom(bands, BHFDRConfig(maxapart=300000), device='cuda')
    # the kernel wrappers refuse tensors they cannot launch on rather than
    # running the twin (a meta tensor stands in for a foreign device)
    raw = torch.empty((8, 16), device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        cuda_scan.scan_pass_a(raw, raw.bool(), (), (), 16)
    oc = torch.empty(16, dtype=torch.int32, device='meta')
    with pytest.raises(ValueError, match='CUDA'):
        cuda_hist.chunk_hist(oc, oc[None], 4, 4)
