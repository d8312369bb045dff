"""The h5py-free modules of ``hicpeaks_tpu.io``, loaded from their files.

``hicpeaks_tpu.io.synth`` and ``hicpeaks_tpu.io.peakfile`` import neither
JAX nor h5py, but importing them through their package runs
``hicpeaks_tpu/io/__init__.py``, which imports the cooler reader and with
it h5py.  A GPU host that runs the port from in-memory bands need not have
h5py, so this loads each module from its file alone.  Served: the
synthetic chromosome (``synthetic_cooler`` writes a cooler and needs h5py
anyway) and the bedpe writers.
"""
from __future__ import annotations

import functools
import importlib.util
import os


@functools.lru_cache(maxsize=None)
def _module(name):
    import hicpeaks_tpu
    path = os.path.join(os.path.dirname(hicpeaks_tpu.__file__), 'io',
                        f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'_hicpeaks_tpu_{name}',
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def synthesize_chrom(*args, **kwargs):
    """``hicpeaks_tpu.io.synth.synthesize_chrom`` (same arguments and
    result)."""
    return _module('synth').synthesize_chrom(*args, **kwargs)


def write_hiccups_bedpe(out, chrom, res, pixel_table):
    """``hicpeaks_tpu.io.peakfile.write_hiccups_bedpe``: the 16-column
    pyHICCUPS bedpe."""
    return _module('peakfile').write_hiccups_bedpe(out, chrom, res,
                                                   pixel_table)


def write_bhfdr_bedpe(out, chrom, res, pixel_table):
    """``hicpeaks_tpu.io.peakfile.write_bhfdr_bedpe``: the 13-column
    pyBHFDR bedpe."""
    return _module('peakfile').write_bhfdr_bedpe(out, chrom, res,
                                                 pixel_table)
