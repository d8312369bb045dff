"""Genome-wide pyHICCUPS and pyBHFDR API (PyTorch).

Port of ``hicpeaks_tpu/api.py``'s ``_run``, ``call_hiccups`` and
``call_bhfdr``: chromosomes stream through the device with per-chromosome
durable checkpoints (JSON peak tables named ``<kind>.<chrom>.json``; a
rerun resumes from them) and a prefetch thread that builds the next
chromosome's host bands while the device works on the current one.
Without a mesh the producer then stages the bands' host-to-device copies
(``engine.stage_chrom_arrays``, as JAX's prefetch thread does): on a card
through pinned memory on the card's copy stream, so the copy leaves the
call's path and can overlap the previous chromosome's call.  The
consumer's call picks the staged tensors up (``engine._staged_operands``):
its stream waits on the staging event before the chromosome's first
kernel.  A staging failure is logged with the chromosome, and the
consumer then copies on its own stream; a mesh copies in the consumer
(``engine.bands_to_device``).

``profile_dir`` captures the chromosome loop with ``torch.profiler``, in
JAX's window (``jax.profiler.start_trace`` after the producer thread
starts, ``stop_trace`` in the loop's ``finally``, so a failed run still
leaves its trace): host ops, and the card's kernels and copies when the
device or a tile of ``mesh`` is CUDA.  The directory is made if missing,
and each process writes one Chrome trace into it
(:func:`trace_file_name`; open it in Perfetto or ``chrome://tracing``),
with each chromosome's call marked ``Chrom:<label>``.  The capture traces
every thread (``core.spans.EveryThread``), so it holds the engine's stage
spans and the prefetch thread's ``hicpeaks.band.read``, ``.build`` and
``.stage``; the consumer's wait on the queue is ``hicpeaks.band.wait``.
A capture on the card that holds no CUDA kernel raises RuntimeError once
the file is written: the trace does not hide the device.

``mesh`` (``parallel.mesh.TileMesh``) runs each chromosome on column
tiles.  In a process group (``parallel.launch.maybe_initialize_distributed``)
the work is split as in JAX (``api.py:77-239``): without a mesh that spans
processes, each process calls its share of the chromosomes
(``parallel.multihost.assign_chroms``), on its own device or its local
mesh, and the tables are all-gathered; with a global mesh every process
works every chromosome on its own tiles, reading only their columns
(``parallel.multihost.sharded_bands_from_cooler``), with the bands built
in the same order on every process and no prefetch thread.  Either way
every process returns the whole genome's table, in the cooler's
chromosome order.

``call_hiccups``/``call_bhfdr`` take the JAX API's parameters in its
order, then the keyword ``device``.  ``device`` defaults to the card (in
a process group, the process's own card,
``parallel.launch.process_device``), or with a ``mesh`` to the mesh's
own device (``mesh.first_device``, this process's first tile, where the
reductions land); the CPU runs only what names it.  ``shape_bucket``,
``row_bucket`` and ``max_count_floor`` are logged as having no effect
(they shared XLA executables; eager PyTorch compiles nothing).
"""
from __future__ import annotations

import json
import logging
import os
import queue
import re
import socket
import threading
import time

import numpy as np
from torch.profiler import ProfilerActivity, record_function

from .cli.common import chrom_selected
from .core import engine
from .core.config import BHFDRConfig, HiccupsConfig
from .core.spans import EveryThread, span
from .ops.band import bands_from_cooler
from .parallel.launch import process_device, world
from .parallel.mesh import check_mesh
from .parallel.multihost import (assign_chroms, gather_tables,
                                 sharded_bands_from_cooler)

log = logging.getLogger(__name__)

_MAX_RETRIES = 1      # per-chromosome retries after a runtime failure


def _ckpt_path(checkpoint_dir, kind, chrom):
    return os.path.join(checkpoint_dir, f'{kind}.{chrom}.json')


def _save_ckpt(path, table):
    payload = {','.join(map(str, k)): list(map(float, v))
               for k, v in table.items()}
    tmp = f'{path}.tmp.{os.getpid()}'   # unique per process: the processes
                                        # of a global mesh write together
    with open(tmp, 'w') as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def _load_ckpt(path):
    with open(path) as f:
        payload = json.load(f)
    return {tuple(int(float(x)) for x in k.split(',')): tuple(v)
            for k, v in payload.items()}


def _selected_chroms(clr, chroms):
    """Cooler chromosomes matching the reference's selection convention:
    labels without any 'chr' prefix, '#' for every numeric chromosome
    (scripts/pyHICCUPS:44-46)."""
    out = [key for key in clr.chromnames if chrom_selected(key, chroms)]
    if chroms and not out:
        log.warning('chromosome selection %s matched none of the cooler\'s '
                    'chromosomes %s (labels are matched after stripping any '
                    '"chr" prefix; use "#" for all numeric chromosomes) — '
                    'the run will produce no output', list(chroms),
                    list(clr.chromnames))
    return out


_NO_EFFECT = {'shape_bucket': 4096, 'row_bucket': 8, 'max_count_floor': None}

# a kernel event of a Chrome trace, as torch's and kineto's writers print it
_KERNEL_EVENT = re.compile(r'"cat":\s*"kernel"')


def trace_file_name(kind, rank, host=None, stamp_ms=None):
    """The Chrome trace one process writes for ``profile_dir``:
    ``<kind>.<host>.rank<rank>.<unix ms>.pt.trace.json`` (rank 0 outside a
    process group), so processes sharing the directory never overwrite
    each other's."""
    host = socket.gethostname() if host is None else host
    stamp_ms = int(time.time() * 1000) if stamp_ms is None else stamp_ms
    return f'{kind}.{host}.rank{rank}.{stamp_ms}.pt.trace.json'


def trace_activities(device, mesh):
    """The host's ops, and the card's activity when ``device`` or a tile
    of ``mesh`` is CUDA."""
    devices = (device,) + (mesh.devices if mesh is not None else ())
    if any(d.type == 'cuda' for d in devices):
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    return [ProfilerActivity.CPU]


def count_kernel_events(path):
    """The CUDA kernel events of the Chrome trace at ``path``, read a line
    at a time (a genome's trace can be large)."""
    with open(path) as f:
        return sum(len(_KERNEL_EVENT.findall(line)) for line in f)


def _run(kind, cooler_uri, cfg, chroms, device, checkpoint_dir, dtype,
         scan_backend, bh_backend, check, mesh, profile_dir, **no_effect):
    from .io.coolerlite import CoolerLite

    check_mesh(mesh)
    for name, value in no_effect.items():
        if value != _NO_EFFECT[name]:
            log.info('%s=%r has no effect on this engine', name, value)
    if device is None:
        device = process_device() if mesh is None else mesh.first_device
    device = engine.resolve_device(device)
    caller = engine.hiccups_chrom if kind == 'hiccups' else engine.bhfdr_chrom
    clr = CoolerLite(cooler_uri)
    results = {}
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    selected = _selected_chroms(clr, chroms)
    my_chroms = selected
    nproc, rank = world()
    global_mesh = mesh is not None and mesh.spans_processes
    if nproc > 1 and not global_mesh:
        my_chroms = assign_chroms(selected, nproc, rank)
        log.info('multi-process: process %d/%d handles chromosomes %s',
                 rank, nproc, my_chroms)
    elif global_mesh:
        log.info('multi-process: global %d-tile mesh across %d processes; '
                 'chromosomes are tile-sharded, ingestion is per process',
                 mesh.size, nproc)
    todo = []
    for key in my_chroms:
        label = key.lstrip('chr')
        if checkpoint_dir:
            ck = _ckpt_path(checkpoint_dir, kind, label)
            if os.path.exists(ck):
                log.info('Chrom:%s, resuming from checkpoint', label)
                results[label] = _load_ckpt(ck)
                continue
        todo.append(key)

    def build(key):
        t0 = time.perf_counter()
        if global_mesh:
            bands = sharded_bands_from_cooler(
                clr, key, cfg.maxapart, cfg.maxww, cfg.ww_min, mesh,
                dtype=dtype, weight_name=cfg.clr_weight_name)
        else:
            bands = bands_from_cooler(clr, key, cfg.maxapart, cfg.maxww,
                                      cfg.ww_min, dtype=dtype,
                                      weight_name=cfg.clr_weight_name,
                                      keep_sparse=False)
        return bands, time.perf_counter() - t0

    # Pipelined ingestion: one producer thread builds the next chromosome's
    # host bands (HDF5 read + native scatter) and, without a mesh, stages
    # their copies to the device, while the device works on the current
    # one; maxsize=1 bounds the bands in flight to three chromosomes (one
    # called, one queued, one in the build).  A global mesh builds in the
    # consumer instead: its ingestion issues collectives, which must run in
    # the same order on every process.
    band_q = queue.Queue(maxsize=1)
    stop = threading.Event()
    # the producer names the card by its index: its current card is its
    # own thread's
    device = engine._indexed(device)

    def _producer():
        for key in todo:
            if stop.is_set():
                return
            try:
                bands, t_band = build(key)
            except BaseException as exc:   # re-raised on the consumer side
                band_q.put((key, None, 0.0, exc))
                return
            if mesh is None:
                try:
                    engine.stage_chrom_arrays(bands, device=device)
                except Exception:
                    log.exception('Chrom:%s, staging the host-to-device '
                                  'copy failed; the call will copy',
                                  key.lstrip('chr'))
            band_q.put((key, bands, t_band, None))

    producer = None
    if not global_mesh:
        producer = threading.Thread(target=_producer,
                                    name=f'{kind}-band-loader', daemon=True)
        producer.start()
    prof = None
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        activities = trace_activities(device, mesh)
        prof = EveryThread(activities)
        prof.start()
    try:
        for key_i in todo:
            if global_mesh:
                key, (bands, t_band), exc = key_i, build(key_i), None
            else:
                with span('hicpeaks.band.wait'):
                    key, bands, t_band, exc = band_q.get()
            label = key.lstrip('chr')
            if exc is not None:
                raise exc
            t0 = time.perf_counter()
            n_cand = bands.nnz()
            attempt = 0
            while True:
                try:
                    # a trace marks each chromosome's call
                    with record_function(f'Chrom:{label}'):
                        table = caller(bands, cfg, mesh=mesh, device=device,
                                       scan_backend=scan_backend,
                                       bh_backend=bh_backend, check=check)
                    break
                except Exception:
                    attempt += 1
                    # a global mesh's processes retry nothing: one
                    # process's retry would run collectives the others
                    # do not
                    if attempt > _MAX_RETRIES or global_mesh:
                        raise
                    log.exception('Chrom:%s, attempt %d failed; retrying',
                                  label, attempt)
                    time.sleep(5 * attempt)
            dt = time.perf_counter() - t0
            log.info('Chrom:%s, %d band pixels scored in %.2fs '
                     '(band build %.2fs, %s; %.0f pixels/s), '
                     '%d peaks', label, n_cand, dt, t_band,
                     'per process' if global_mesh else 'pipelined',
                     n_cand / max(dt, 1e-9), len(table))
            results[label] = table
            if checkpoint_dir:
                # every process of a global mesh writes the same table
                # (atomic replace, pid-unique temporary name)
                _save_ckpt(_ckpt_path(checkpoint_dir, kind, label), table)
    finally:
        # unblock the producer if we leave early: it finishes at most the
        # in-flight build, then exits
        stop.set()
        while producer is not None and producer.is_alive():
            try:
                band_q.get_nowait()
            except queue.Empty:
                time.sleep(0.05)
        if prof is not None:
            prof.stop()
            trace = os.path.join(profile_dir, trace_file_name(kind, rank))
            prof.export_chrome_trace(trace)
            log.info('profile trace written to %s', trace)
    if (prof is not None and todo and ProfilerActivity.CUDA in activities
            and count_kernel_events(trace) == 0):
        raise RuntimeError(
            f'profile_dir: the trace {trace} holds no CUDA kernel although '
            'the run used the card: CUPTI was not found, or the card was '
            'not traced')
    if nproc > 1 and not global_mesh:
        gathered = gather_tables(results)
        results = {key.lstrip('chr'): gathered[key.lstrip('chr')]
                   for key in selected}
    return results


def call_hiccups(cooler_uri, cfg: HiccupsConfig = None, chroms=('#', 'X'),
                 mesh=None, scan_backend='auto', checkpoint_dir=None,
                 dtype=np.float32, profile_dir=None, shape_bucket=4096,
                 bh_backend='auto', check=False, row_bucket=8,
                 max_count_floor=None, *, device=None):
    """-> {chrom_label: {(x_bp, y_bp): 10-tuple}} (see
    ``engine.hiccups_chrom``, whose ``scan_backend``, ``bh_backend`` and
    ``check`` these are), every chromosome on ``device`` (default the
    card), or on ``mesh``'s tiles.  The parameters are the JAX API's
    (module docstring)."""
    return _run('hiccups', cooler_uri, cfg or HiccupsConfig(), chroms,
                device, checkpoint_dir, dtype, scan_backend, bh_backend,
                check, mesh, profile_dir=profile_dir,
                shape_bucket=shape_bucket, row_bucket=row_bucket,
                max_count_floor=max_count_floor)


def call_bhfdr(cooler_uri, cfg: BHFDRConfig = None, chroms=('#', 'X'),
               mesh=None, scan_backend='auto', checkpoint_dir=None,
               dtype=np.float32, profile_dir=None, shape_bucket=4096,
               bh_backend='auto', check=False, row_bucket=8,
               max_count_floor=None, *, device=None):
    """-> {chrom_label: {(x_bp, y_bp): 7-tuple}} (see
    ``engine.bhfdr_chrom``), every chromosome on ``device`` or on
    ``mesh``'s tiles; the parameters are those of :func:`call_hiccups`."""
    return _run('bhfdr', cooler_uri, cfg or BHFDRConfig(), chroms, device,
                checkpoint_dir, dtype, scan_backend, bh_backend, check, mesh,
                profile_dir=profile_dir, shape_bucket=shape_bucket,
                row_bucket=row_bucket, max_count_floor=max_count_floor)
