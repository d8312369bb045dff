"""hicpeaks-tpu on PyTorch and CUDA: the pyHICCUPS and pyBHFDR callers for
one GPU.

A port of ``hicpeaks_tpu`` (the JAX package, which stays the reference)
that keeps its layout and function names, so each module here names its
counterpart.  Plain tensor code is PyTorch; the three Pallas kernels are
CUDA kernels written for Hopper (``csrc/``), each with a plain PyTorch twin
that runs for CPU tensors.  The command-line tools are
``python -m hicpeaks_tpu_torch.cli.peakcall {pyHICCUPS|pyBHFDR}``.

Rules the package keeps:

* it never imports ``jax``; the JAX-free host modules of ``hicpeaks_tpu``
  (band build, pool plan, clustering, float64 host recomputation, the CLI
  helpers) are imported as they are;
* every public entry point takes an explicit ``device``; a CUDA tensor is
  served by its kernel or the call raises — nothing falls back to the CPU.
"""

__version__ = '0.1.0'

_LAZY = {'call_hiccups': 'api', 'call_bhfdr': 'api',
         'hiccups_chrom': 'core.engine', 'bhfdr_chrom': 'core.engine'}


def __getattr__(name):
    """Lazy public API: call_hiccups / call_bhfdr / hiccups_chrom /
    bhfdr_chrom."""
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__),
                   name)
