"""Synthetic chromosomes without h5py.

``hicpeaks_tpu.io.synth`` is JAX-free, but importing it through its
package runs ``hicpeaks_tpu/io/__init__.py``, which imports the cooler
reader and with it h5py.  A GPU host that runs the port from in-memory
bands need not have h5py, so this loads the module from its file alone.
Only ``synthesize_chrom`` is served: ``synthetic_cooler`` writes a cooler
and needs h5py anyway.
"""
from __future__ import annotations

import functools
import importlib.util
import os


@functools.lru_cache(maxsize=1)
def _module():
    import hicpeaks_tpu
    path = os.path.join(os.path.dirname(hicpeaks_tpu.__file__), 'io',
                        'synth.py')
    spec = importlib.util.spec_from_file_location('_hicpeaks_tpu_synth',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthesize_chrom(*args, **kwargs):
    """``hicpeaks_tpu.io.synth.synthesize_chrom`` (same arguments and
    result)."""
    return _module().synthesize_chrom(*args, **kwargs)
