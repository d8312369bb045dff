"""hicpeaks-tpu on PyTorch and CUDA: the pyHICCUPS and pyBHFDR callers on
one GPU, on a mesh of column tiles, or across torch.distributed processes
(``parallel/``).

A port of ``hicpeaks_tpu`` (the JAX package, which stays the reference)
that keeps its layout and function names, so each module here names its
counterpart.  Plain tensor code is PyTorch; the three Pallas kernels are
CUDA kernels written for Hopper (``csrc/``), each with a plain PyTorch twin
that runs for CPU tensors.  The command-line tools are
``python -m hicpeaks_tpu_torch.cli.peakcall {pyHICCUPS|pyBHFDR}``,
``python -m hicpeaks_tpu_torch.cli.tocooler`` and
``python -m hicpeaks_tpu_torch.cli.{apa,combine,peakplot}``; coolers are
read and written by ``io/h5lite`` (numpy and zlib, no h5py).

Rules the package keeps:

* it imports nothing of ``jax``, ``hicpeaks_tpu`` or ``h5py``: the host
  modules it needs (band build and its native C++ library, TXT parsing,
  ingestion, pool plan, clustering, float64 host recomputation, cooler and
  bedpe I/O, the CLI helpers) are
  copies kept here under the same module names, and the native library is
  built from ``csrc/host/`` at first use;
* every public entry point takes a ``device`` (the card unless the caller
  names the CPU); a CUDA tensor is served by its kernel or the call raises
  — nothing falls back to the CPU.
"""

__version__ = '0.1.0'

_LAZY = {'call_hiccups': 'api', 'call_bhfdr': 'api',
         'hiccups_chrom': 'core.engine', 'bhfdr_chrom': 'core.engine',
         'balance': 'ops.ice', 'CoolerLite': 'io.coolerlite'}


def __getattr__(name):
    """Lazy public API: call_hiccups / call_bhfdr / hiccups_chrom /
    bhfdr_chrom / balance / CoolerLite."""
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib
    return getattr(importlib.import_module(f'.{_LAZY[name]}', __name__),
                   name)
