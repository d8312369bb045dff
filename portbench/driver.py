"""The traffic mixes' one generator: what a cell's window calls.

A traffic file (``portbench/traffic/<mix>.json``) holds a mix's
parameters and names its ``entry``, a module
``portbench/mixes/<entry>.py`` whose ``ENTRY`` class (an :class:`Entry`)
sets up the cell's inputs, makes one timed call a step and computes the
reference of what the window returned.  A configuration
(``portbench/configs/<config>.json``) names the caller (``caller``: the
program's ``engine.<caller>_chrom`` and ``api.call_<caller>``), the
program's settings class (``program_config``, in
``hicpeaks_tpu_torch.core.config``), its reference (``reference``:
``<module>.<function>`` under ``portbench/reference/``), the settings,
the genome and the synthesis.  A new mix, caller or reference is a new
file found by these names.

The reference works from the same pixels and weights the program got,
chromosome by chromosome.
"""
from __future__ import annotations

import importlib
import importlib.util
import os
import sys

import numpy as np

from .gen import synth


def n_bins(size, res):
    return -(-int(size) // int(res))


def load_in_package(root, sub, name):
    """Module ``portbench/<sub>/<name>.py`` under ``root``, as
    ``portbench.<sub>.<name>`` (so that its relative imports resolve in
    the benchmark's package)."""
    modname = f'portbench.{sub}.{name}'
    path = os.path.join(root, 'portbench', sub, f'{name}.py')
    mod = sys.modules.get(modname)
    if mod is not None and os.path.samefile(mod.__file__, path):
        return mod
    importlib.import_module(f'portbench.{sub}')
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def program_config(config):
    """The program's settings object of a configuration: the class its
    ``program_config`` names, with its ``settings`` (lists as tuples)."""
    from hicpeaks_tpu_torch.core import config as settings
    cls = getattr(settings, config['program_config'])
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in config['settings'].items()})


def ww_min(config):
    ww = config['settings']['ww']
    return min(ww) if isinstance(ww, list) else int(ww)


class Entry:
    """One cell's inputs, its timed call and its reference.  A mix's
    ``ENTRY`` sets ``fn``, ``arg`` and ``inputs`` (a dict that describes
    the inputs, for the result line) in ``setup`` and defines ``unit``,
    ``free``, ``reference`` and ``gap``."""

    def __init__(self, root, config, traffic, seed, device):
        self.root, self.config, self.traffic = root, config, traffic
        self.seed, self.device = seed, device
        self.caller = config['caller']
        self.res = int(config['res'])
        self.settings = config['settings']
        self.cfg = program_config(config)
        self.num = self.settings['maxapart'] // self.res + \
            int(self.settings['maxww']) + 1
        module, func = config['reference'].rsplit('.', 1)
        self.reference_fn = getattr(
            load_in_package(root, 'reference', module), func)

    def n_bins(self, label):
        return n_bins(self.config['chromsizes'][label], self.res)

    def pixels(self, label):
        """(bin1, bin2, count, weights, bias, L) of the band of chromosome
        ``label`` (the diagonals ``synth.band_span`` draws pixel by
        pixel), drawn from the seed."""
        L = self.n_bins(label)
        return synth.chrom_pixels(self.config['synthesis'], L, self.res,
                                  self.seed, self.index(label)) + (L,)

    def index(self, label):
        return list(self.config['chromsizes']).index(label)

    def band_shape(self, b1, b2, ct, L):
        """The band's shape and candidates, for the roofline."""
        d = b2 - b1
        d_lo, d_hi = ww_min(self.config), self.settings['maxapart'] // self.res
        return dict(L=int(L), num=self.num,
                    n_cand=int(np.count_nonzero((d >= d_lo) & (d <= d_hi)
                                                & (ct != 0))))

    def step(self, **kw):
        """One timed call: the caller on the cell's input (``kw``: the
        caller's other parameters, which the window leaves at their
        defaults)."""
        return self.fn(self.arg, self.cfg, device=self.device, **kw)

    def reference_table(self, b1, b2, ct, w, L, dtype=np.float64):
        """The configuration's reference on one chromosome's pixels."""
        return self.reference_fn((b1, b2, ct, w, L, self.res), self.settings,
                                 self.device, dtype)


def make_entry(root, config, traffic, seed, device):
    """The entry of ``traffic``'s mix (``portbench/mixes/<entry>.py``
    under ``root``) for one run."""
    mod = load_in_package(root, 'mixes', traffic['entry'])
    return mod.ENTRY(root, config, traffic, seed, device)
