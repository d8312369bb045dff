"""hicpeaks-tpu on PyTorch and CUDA: the pyHICCUPS main path for one GPU.

A port of ``hicpeaks_tpu`` (the JAX package, which stays the reference)
that keeps its layout and function names, so each module here names its
counterpart.  Plain tensor code is PyTorch; the three Pallas kernels of the
main path are CUDA kernels written for Hopper (``csrc/``), each with a plain
PyTorch twin that runs for CPU tensors.

Rules the package keeps:

* it never imports ``jax``; the JAX-free host modules of ``hicpeaks_tpu``
  (band build, pool plan, clustering, float64 host recomputation) are
  imported as they are;
* every public entry point takes an explicit ``device``; a CUDA tensor is
  served by its kernel or the call raises — nothing falls back to the CPU.
"""

__version__ = '0.1.0'


def __getattr__(name):
    """Lazy public API: hicpeaks_tpu_torch.call_hiccups / hiccups_chrom."""
    if name == 'call_hiccups':
        from .api import call_hiccups
        return call_hiccups
    if name == 'hiccups_chrom':
        from .core.engine import hiccups_chrom
        return hiccups_chrom
    raise AttributeError(name)
