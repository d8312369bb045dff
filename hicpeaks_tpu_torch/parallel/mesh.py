"""The tile mesh: which device runs each column tile of a chromosome band.

Port of ``hicpeaks_tpu/parallel/mesh.py``.  JAX's mesh is a
``jax.sharding.Mesh`` over its device list; the port's is an ordered list
of ``torch.device``s, one per column tile, plus the rank of the process
that owns each tile when the mesh spans processes
(:func:`hicpeaks_tpu_torch.parallel.multihost.global_tile_mesh`).

A device list may name one device more than once: four tiles on one card
(``['cuda:0'] * 4``), or eight on the CPU (``['cpu'] * 8``), are the
port's counterpart of XLA's forced host-device count.  The tiles then
take turns on the device; the halos, the reductions and the merge are
those of a mesh of distinct cards.
"""
from __future__ import annotations

import logging

import torch

log = logging.getLogger(__name__)


class TileMesh:
    """A 1-D mesh: tile i runs on ``devices[i]`` in process ``owners[i]``.

    ``rank`` is this process's rank.  Without ``owners`` every tile is
    this process's (a local mesh)."""

    def __init__(self, devices, owners=None, rank=0):
        if not devices:
            raise ValueError('a tile mesh needs at least one device')
        self.devices = tuple(torch.device(d) for d in devices)
        self.rank = int(rank)
        self.owners = (tuple(int(o) for o in owners) if owners is not None
                       else (self.rank,) * len(self.devices))
        if len(self.owners) != len(self.devices):
            raise ValueError(f'{len(self.devices)} devices but '
                             f'{len(self.owners)} owners')
        if self.rank not in self.owners:
            raise ValueError(f'process {self.rank} owns no tile of the mesh')

    @property
    def size(self):
        """The number of column tiles."""
        return len(self.devices)

    def is_local(self, i):
        return self.owners[i] == self.rank

    @property
    def local_tiles(self):
        return [i for i in range(self.size) if self.is_local(i)]

    @property
    def spans_processes(self):
        """Whether other processes own tiles of this mesh (a global mesh:
        halos and reductions cross processes)."""
        return any(o != self.rank for o in self.owners)

    @property
    def first_device(self):
        """The device of this process's first tile: the reductions (the
        per-tile sums, the gathers) land there."""
        return self.devices[self.local_tiles[0]]

    def __repr__(self):
        devs = ', '.join(str(d) for d in self.devices)
        if not self.spans_processes:
            return f'TileMesh([{devs}])'
        return f'TileMesh([{devs}], owners={list(self.owners)}, ' \
            f'rank={self.rank})'


def make_tile_mesh(n_devices=None, devices=None):
    """A local tile mesh (JAX ``parallel/mesh.py:17-22``).

    Without ``devices`` it takes the first ``n_devices`` CUDA cards (every
    card when None), as JAX takes ``jax.devices()[:n]``, logs the mesh and
    warns when fewer than ``n_devices`` cards are present; without CUDA it
    raises RuntimeError (the port never falls back to the CPU).  An
    explicit ``devices`` list may repeat a device; ``n_devices`` then
    truncates it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_tile_mesh: no CUDA device; pass '
                               "devices=['cpu'] * n for CPU tiles")
        n_cards = torch.cuda.device_count()
        if n_devices is not None and n_devices > n_cards:
            log.warning('make_tile_mesh: %d devices asked for, %d CUDA '
                        'cards present; the mesh has %d tiles', n_devices,
                        n_cards, n_cards)
        devices = [f'cuda:{i}' for i in range(n_cards)]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    mesh = TileMesh(devices)
    log.info('tile mesh: %r', mesh)
    return mesh


def check_mesh(mesh):
    """TypeError unless ``mesh`` is None or a :class:`TileMesh`."""
    if mesh is not None and not isinstance(mesh, TileMesh):
        raise TypeError(f'mesh must be a TileMesh (parallel.mesh.'
                        f'make_tile_mesh), got {type(mesh).__name__}')
