"""The port's boundary: hicpeaks_tpu_torch (engines, API, the peak-calling
CLIs from a cooler, toCooler) imports nothing of JAX, of the JAX package or
of h5py (coolers go through the port's io/h5lite), and a CUDA request on a
machine without CUDA raises instead of running on the CPU.

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
    import importlib.abc
    import sys


    class Refuse(importlib.abc.MetaPathFinder):
        """Refuses jax, the JAX package and h5py for the whole run."""

        def find_spec(self, name, path=None, target=None):
            if name.split('.')[0] in ('jax', 'hicpeaks_tpu', 'h5py'):
                raise ImportError(f'the port imported {name}')
            return None


    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import hicpeaks_tpu_torch
    import hicpeaks_tpu_torch.api
    import hicpeaks_tpu_torch.cli.peakcall as cli
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.core.engine import bhfdr_chrom, hiccups_chrom
    from hicpeaks_tpu_torch.io.peakfile import write_bhfdr_bedpe
    from hicpeaks_tpu_torch.io.synth import synthesize_chrom
    from hicpeaks_tpu_torch.ops.band import build_bands

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

    # toCooler from TXT, then the pyBHFDR CLI on a synthetic cooler
    import hicpeaks_tpu_torch.cli.tocooler as toc
    from hicpeaks_tpu_torch.io.coolerlite import CoolerLite
    from hicpeaks_tpu_torch.io.synth import synthetic_cooler, write_txt
    tmp = sys.argv[1]
    import os
    os.makedirs(f'{tmp}/txt')
    write_txt(f'{tmp}/txt/1_1.txt', b1, b2, ct)
    with open(f'{tmp}/sizes', 'w') as f:
        f.write(f'chr1\\t{L * res}\\n')
    with open(f'{tmp}/meta', 'w') as f:
        f.write(f'res:{res}\\n{tmp}/txt\\n')
    rc_toc = toc.main(['-O', f'{tmp}/toc.cool', '-d', f'{tmp}/meta',
                       '--chromsizes-file', f'{tmp}/sizes', '--device', 'cpu',
                       '--logFile', f'{tmp}/toc.log'])
    n_weights = int((CoolerLite(f'{tmp}/toc.cool::{res}').weights() > 0)
                    .sum())
    uri, _ = synthetic_cooler(f'{tmp}/probe.cool', n_bins=400, res=res,
                              chrom='1', seed=3, depth=40.0, n_loops=20,
                              decay=0.75, max_loop_span_bins=150)
    rc = cli.main(['pyBHFDR', '-O', f'{tmp}/probe.bedpe', '-p', uri,
                   '--maxapart', '1000000', '--device', 'cpu',
                   '--logFile', f'{tmp}/probe.log'])
    with open(f'{tmp}/probe.bedpe') as f:
        n_lines = len(f.read().splitlines())
    jaxpkg = sorted(m for m in sys.modules
                    if m.split('.')[0] in ('jax', 'hicpeaks_tpu', 'h5py'))
    print(len(table), len(btable), rc, n_lines, rc_toc, n_weights,
          ','.join(jaxpkg) or '-')
''')


def test_port_never_imports_jax_or_h5py(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, '-c', _PROBE, str(tmp_path)],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_peaks, n_bhfdr, rc, n_lines, rc_toc, n_weights, jaxpkg = \
        proc.stdout.split()
    assert int(n_peaks) > 0 and int(n_bhfdr) > 0
    assert (rc, rc_toc) == ('0', '0')
    assert int(n_lines) > 0 and int(n_weights) > 400
    assert jaxpkg == '-', f'modules of jax, hicpeaks_tpu or h5py: {jaxpkg}'


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the refusal path needs none')
    from hicpeaks_tpu_torch.core.config import BHFDRConfig, HiccupsConfig
    from hicpeaks_tpu_torch.core.engine import bhfdr_chrom, hiccups_chrom
    from hicpeaks_tpu_torch.ops import cuda_hist, cuda_scan
    from hicpeaks_tpu_torch.ops.band import build_bands

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
