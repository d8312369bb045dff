"""Multi-process launch on ``torch.distributed``.

Port of ``hicpeaks_tpu/parallel/launch.py``.  Every process runs the same
program with three environment variables set:

  HICPEAKS_COORDINATOR    host:port of process 0 (a free TCP port there)
  HICPEAKS_NUM_PROCESSES  the number of processes
  HICPEAKS_PROCESS_ID     this process's rank, 0 .. N-1

:func:`maybe_initialize_distributed` joins the process group.  The
transport follows one rule, decided once at init and logged:

* host data (the peak tables, the ingestion partials, the compacted
  pixels, the exact integer sums) always moves on the default gloo group,
  as JAX's ``process_allgather`` moves host numpy data;
* device tensors that cross processes (the halos and the per-tile counts
  of a mesh that spans processes) move on an NCCL group when every
  process on each host has a card of its own, and on the gloo group,
  staged through host memory, when processes share a card (NCCL refuses
  two ranks on one GPU) or run on the CPU.

Each process's device is ``cuda:{local_rank % torch.cuda.device_count()}``,
``local_rank`` being its index among the processes of its host.
"""
from __future__ import annotations

import logging
import os
import socket

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

# set by maybe_initialize_distributed: the process group's facts that every
# later collective needs (torch.distributed keeps the group itself globally)
_RUN = {}


def maybe_initialize_distributed():
    """Join the process group when the HICPEAKS_* variables are set
    (JAX ``launch.py:24-39``).  Returns True when this process runs in a
    group (also when it joined earlier), False without the variables."""
    coord = os.environ.get('HICPEAKS_COORDINATOR')
    if not coord:
        return False
    if dist.is_initialized():
        return True
    nproc = int(os.environ['HICPEAKS_NUM_PROCESSES'])
    pid = int(os.environ['HICPEAKS_PROCESS_ID'])
    dist.init_process_group('gloo', init_method=f'tcp://{coord}',
                            world_size=nproc, rank=pid)
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    peers = [None] * nproc
    dist.all_gather_object(peers, (socket.gethostname(), n_cards))
    host = peers[pid][0]
    local_rank = sum(1 for h, _ in peers[:pid] if h == host)
    per_host = {}
    for h, _ in peers:
        per_host[h] = per_host.get(h, 0) + 1
    # NCCL needs a card of its own for every rank
    own_cards = all(n > 0 and per_host[h] <= n for h, n in peers)
    transport = 'nccl' if own_cards else 'gloo'
    device_group = dist.new_group(backend='nccl') if own_cards else None
    device = (torch.device(f'cuda:{local_rank % n_cards}') if n_cards
              else torch.device('cpu'))
    _RUN.update(transport=transport, device_group=device_group,
                device=device, local_rank=local_rank)
    log.info('torch.distributed: process %d/%d via tcp://%s, device %s; '
             'host data on gloo, device tensors across processes on %s%s',
             pid, nproc, coord, device, transport,
             '' if own_cards else ' staged through host memory (processes '
             'share a card or run on the CPU)')
    return True


def shutdown_distributed():
    """Leave the process group after a barrier, so no process closes the
    rendezvous while another still uses it; nothing outside a group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
        _RUN.clear()


def world():
    """(number of processes, this process's rank): (1, 0) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def process_device(device='cuda'):
    """This process's device for a ``device`` request: in a process group,
    a bare 'cuda' becomes the process's own card; anything else is kept."""
    device = torch.device(device)
    mine = _RUN.get('device')
    if device.type == 'cuda' and device.index is None and mine is not None \
            and mine.type == 'cuda':
        return mine
    return device


def device_transport():
    """('nccl', group) or ('gloo', None): how device tensors cross
    processes (module docstring)."""
    return _RUN.get('transport', 'gloo'), _RUN.get('device_group')
