"""Genome-wide pyHICCUPS and pyBHFDR API on one device (PyTorch).

Port of ``hicpeaks_tpu/api.py``'s ``_run``, ``call_hiccups`` and
``call_bhfdr``: chromosomes stream through one device with per-chromosome
durable checkpoints (JSON peak tables named ``<kind>.<chrom>.json``; a
rerun resumes from them) and a prefetch thread that builds the next
chromosome's host bands while the device works on the current one.  The
consumer does the host-to-device copy (``engine.bands_to_device``).  The
``jax.distributed`` branches and the profiler capture are not ported.
"""
from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time

import numpy as np

from .cli.common import chrom_selected
from .core import engine
from .core.config import BHFDRConfig, HiccupsConfig
from .ops.band import bands_from_cooler

log = logging.getLogger(__name__)

_MAX_RETRIES = 1      # per-chromosome retries after a runtime failure


def _ckpt_path(checkpoint_dir, kind, chrom):
    return os.path.join(checkpoint_dir, f'{kind}.{chrom}.json')


def _save_ckpt(path, table):
    payload = {','.join(map(str, k)): list(map(float, v))
               for k, v in table.items()}
    tmp = f'{path}.tmp.{os.getpid()}'
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


def _run(kind, cooler_uri, cfg, chroms, device, checkpoint_dir, dtype,
         scan_backend, bh_backend, check):
    # h5py only where a cooler is read: the engine itself never needs it
    from .io.coolerlite import CoolerLite

    device = engine.resolve_device(device)
    caller = engine.hiccups_chrom if kind == 'hiccups' else engine.bhfdr_chrom
    clr = CoolerLite(cooler_uri)
    results = {}
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    todo = []
    for key in _selected_chroms(clr, chroms):
        label = key.lstrip('chr')
        if checkpoint_dir:
            ck = _ckpt_path(checkpoint_dir, kind, label)
            if os.path.exists(ck):
                log.info('Chrom:%s, resuming from checkpoint', label)
                results[label] = _load_ckpt(ck)
                continue
        todo.append(key)

    # Pipelined ingestion: one producer thread builds the next chromosome's
    # host bands (HDF5 read + native scatter) while the device works on the
    # current one; maxsize=1 bounds in-flight bands to two chromosomes.
    # h5py handles are touched only by this thread once it starts.
    band_q = queue.Queue(maxsize=1)
    stop = threading.Event()

    def _producer():
        for key in todo:
            if stop.is_set():
                return
            t0 = time.perf_counter()
            try:
                bands = bands_from_cooler(clr, key, cfg.maxapart, cfg.maxww,
                                          cfg.ww_min, dtype=dtype,
                                          weight_name=cfg.clr_weight_name,
                                          keep_sparse=False)
            except BaseException as exc:   # re-raised on the consumer side
                band_q.put((key, None, time.perf_counter() - t0, exc))
                return
            band_q.put((key, bands, time.perf_counter() - t0, None))

    producer = threading.Thread(target=_producer,
                                name=f'{kind}-band-loader', daemon=True)
    producer.start()
    try:
        for _ in todo:
            key, bands, t_band, exc = band_q.get()
            label = key.lstrip('chr')
            if exc is not None:
                raise exc
            t0 = time.perf_counter()
            n_cand = bands.nnz()
            attempt = 0
            while True:
                try:
                    table = caller(bands, cfg, device,
                                   scan_backend=scan_backend,
                                   bh_backend=bh_backend, check=check)
                    break
                except Exception:
                    attempt += 1
                    if attempt > _MAX_RETRIES:
                        raise
                    log.exception('Chrom:%s, attempt %d failed; retrying',
                                  label, attempt)
                    time.sleep(5 * attempt)
            dt = time.perf_counter() - t0
            log.info('Chrom:%s, %d band pixels scored in %.2fs '
                     '(band build %.2fs, pipelined; %.0f pixels/s), '
                     '%d peaks', label, n_cand, dt, t_band,
                     n_cand / max(dt, 1e-9), len(table))
            results[label] = table
            if checkpoint_dir:
                _save_ckpt(_ckpt_path(checkpoint_dir, kind, label), table)
    finally:
        # unblock the producer if we leave early: it finishes at most the
        # in-flight build, then exits
        stop.set()
        while producer.is_alive():
            try:
                band_q.get_nowait()
            except queue.Empty:
                time.sleep(0.05)
    return results


def call_hiccups(cooler_uri, cfg: HiccupsConfig = None, chroms=('#', 'X'), *,
                 device, checkpoint_dir=None, dtype=np.float32,
                 scan_backend='auto', bh_backend='auto', check=False):
    """-> {chrom_label: {(x_bp, y_bp): 10-tuple}} (see
    ``engine.hiccups_chrom``, whose ``scan_backend``, ``bh_backend`` and
    ``check`` these are), every chromosome on ``device``.

    The JAX API's ``shape_bucket``/``row_bucket``/``max_count_floor`` are
    not ported: they padded shapes so XLA executables could be shared, and
    eager PyTorch compiles nothing."""
    return _run('hiccups', cooler_uri, cfg or HiccupsConfig(), chroms,
                device, checkpoint_dir, dtype, scan_backend, bh_backend,
                check)


def call_bhfdr(cooler_uri, cfg: BHFDRConfig = None, chroms=('#', 'X'), *,
               device, checkpoint_dir=None, dtype=np.float32,
               scan_backend='auto', bh_backend='auto', check=False):
    """-> {chrom_label: {(x_bp, y_bp): 7-tuple}} (see
    ``engine.bhfdr_chrom``), every chromosome on ``device``; the arguments
    are those of :func:`call_hiccups`."""
    return _run('bhfdr', cooler_uri, cfg or BHFDRConfig(), chroms, device,
                checkpoint_dir, dtype, scan_backend, bh_backend, check)
