"""Per-chromosome pyHICCUPS and pyBHFDR engines on one device (PyTorch).

Port of ``hicpeaks_tpu/core/engine.py`` on one device: the fused route and
the fallback ladder, with the routes chosen by :func:`resolve_route`.
Every route runs the same front (:func:`_scan_front`): the sheets, pass A
(CUDA kernel), the freeze gate, pass B (CUDA kernel).  The routes differ
in where the gate is computed and in the scorer:

* **fused** (``hicpeaks_tpu``'s ``_fused_*_device``): the integer-exact
  gate on the device, then the batched pyHICCUPS scorer with its (chunk,
  count) histogram (CUDA kernel), or the pyBHFDR global-BH scorer;
* **host gate** (``engine.py:1409-1418,1520-1530``): pass A's counts
  replayed on the host in Python integers (a candidate total whose
  ``10 * total`` reaches :data:`_GATE_LIMIT` overflows the device gate's
  int32, and ``scan_backend='validate'`` takes this route); the scorers
  are the fused route's;
* **per-background scorer** (:func:`_score_one`, ``engine.py:1165-1259``):
  the histogram scorer for one background, device segmented BH for counts
  above the histogram's cap, or the dense scorer with float64 BH on the
  host (``bh_backend='host'``, and the one background whose suspect audit
  fails);
* **checkify** (``check=True``): the per-background scorer with the
  checks of :func:`_check_finite` and :func:`_check_in_band`.

On the host: the freeze replay, the float64 completion
(:mod:`.hostcomplete`; the fused pyHICCUPS scorer's completes on the
device, :mod:`.complete64`), the fold gates, the cross-pair merge and the
clustering (:mod:`.clustering`).

Under a running ``torch.profiler`` capture each call is a
``hicpeaks.call`` span holding its stages' spans (:mod:`.spans`):
``hicpeaks.h2d``, ``.sheets``, ``.scan``, ``.replay``, ``.score``,
``.dense_fallback``, ``.complete64``, ``.host_complete``, ``.merge``,
``.clustering``, and one ``hicpeaks.sync`` around each blocking
device-to-host read.

With a ``mesh`` (``parallel.mesh.TileMesh``) every route runs on column
tiles (:mod:`..parallel.tiles`): the sheets are cut into tiles, pass A and
pass B run once per tile on its halo-extended slab, the freeze gate is
replayed on the host (JAX never takes its fused route on a mesh), and the
batched pyHICCUPS scorer and the pyBHFDR global-BH scorer run tile by tile
with their histogram and counts summed over the tiles and the compactions
merged in row-major order (:func:`_mesh_hiccups_scored`,
:func:`_bhfdr_tiles`); unlike JAX's mesh route, the tiles set the
lambda-chunk edge suspects aside, so a mesh table is the single-device
table (:func:`_hiccups_tiles`).  The routes that need
the whole chromosome at once (segmented BH, the dense scorer, checkify)
gather the tiles' sheets and captures onto the mesh's first device and run
the single-device scorer there; JAX leaves that step to GSPMD's
collectives.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import cuda_scan, cuda_score
from ..ops import scan as scan_ops
from ..ops import score as score_ops
from ..ops.band import ChromBands
from ..ops.hostexact import ExactCtx
from ..ops.score import Compacted, Suspects, one_background
from ..parallel import tiles
from ..parallel.mesh import check_mesh
from . import poolplan
from .clustering import local_clustering
from .complete64 import complete_on_device
from .config import BHFDRConfig, HiccupsConfig
from .hostcomplete import (_bhfdr_to_host, _compact_to_host, _dense_to_host,
                           _segmented_to_host)
from .spans import SYNC, span

_BH_SLACK = 0.01   # chunk_bh_keep superset inflation: covers the f32 qtab's
                   # gammainc error near q ~ sig, so the device keep mask is
                   # a superset of the float64 rejection set

_MAX_O_CAP = 1 << 17   # the histogram-BH count cap (engine._bh_plan)

_GATE_LIMIT = 1 << 31   # the device freeze gate compares 10 * total in int32

_BHFDR_THR = 16   # pyBHFDR's fixed local-reads freeze threshold
                  # (callers.py:505); BHFDRConfig has no such field

SCAN_BACKENDS = ('auto', 'pallas', 'jnp', 'validate', 'pallas-interpret')
BH_BACKENDS = ('auto', 'host', 'device')


def resolve_device(device=None):
    """``device`` as a torch.device, None being the card (``'cuda'``); a
    CUDA device on a machine without CUDA raises RuntimeError rather than
    running anywhere else: the CPU runs only what asks for it."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device} requested but CUDA is not '
                           'available')
    return device


_OPERANDS = ('raw', 'w0', 'bias', 'IR', 'gap')


def bands_to_device(bands: ChromBands, device):
    """The chromosome's device operands (raw, w0, bias, IR, gap) as
    tensors, with the numpy dtypes kept, copied now by the calling thread
    on its current stream from the bands' pageable numpy arrays (on the
    CPU the tensors share the arrays' memory).  The mesh routes copy
    through it; one device copies through :func:`_staged_operands`, which
    comes here only when nothing was staged for its device."""
    return {k: torch.as_tensor(np.ascontiguousarray(getattr(bands, k)),
                               device=device)
            for k in _OPERANDS}


class Staged(NamedTuple):
    """One chromosome's operands staged by :func:`stage_chrom_arrays`."""
    tensors: dict          # {operand: tensor on ``device``}
    device: torch.device   # with its index
    event: object          # torch.cuda.Event after the copies; None on CPU
    pinned: dict           # the pinned host sources of the copies


_COPY_STREAMS = {}   # one copy stream a card, made at its first staging


def _indexed(device):
    """``device`` with its index: a bare 'cuda' is the calling thread's
    current card (the current card is per thread)."""
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def stage_chrom_arrays(bands: ChromBands, *, device=None):
    """Issue the chromosome's host-to-device copies ahead of its call
    (``hicpeaks_tpu``'s ``stage_chrom_arrays``), into ``bands._staged``.

    ``api._run``'s prefetch thread calls it right after the band build,
    so on a card the copies can overlap the previous chromosome's work:
    each operand is copied into pinned host memory (torch's caching host
    allocator, so each chromosome in flight holds blocks of its own),
    then to ``device`` (default the card) with ``non_blocking`` on the
    card's copy stream, and an event is recorded after the last copy.
    The pinned sources stay with the staged record.  On the CPU the
    record holds :func:`bands_to_device`'s tensors.  Each staged
    chromosome adds one to ``stage_chrom_arrays.staged``."""
    device = _indexed(resolve_device(device))
    with span('hicpeaks.band.stage'):
        if device.type != 'cuda':
            bands._staged = Staged(bands_to_device(bands, device), device,
                                   None, {})
        else:
            pinned = {k: torch.from_numpy(np.ascontiguousarray(
                          getattr(bands, k))).pin_memory()
                      for k in _OPERANDS}
            with torch.cuda.device(device):
                stream = _COPY_STREAMS.get(device)
                if stream is None:
                    stream = _COPY_STREAMS.setdefault(
                        device, torch.cuda.Stream(device=device))
                with torch.cuda.stream(stream):
                    tensors = {k: t.to(device, non_blocking=True)
                               for k, t in pinned.items()}
                    event = torch.cuda.Event()
                    event.record(stream)
            bands._staged = Staged(tensors, device, event, pinned)
    stage_chrom_arrays.staged += 1


stage_chrom_arrays.staged = 0


def _staged_operands(bands: ChromBands, device):
    """The operands of a one-device call (JAX ``engine.py:151-181``): the
    tensors :func:`stage_chrom_arrays` staged on ``device``, else a copy
    now (:func:`bands_to_device`).  On a card the calling thread's current
    stream waits on the staging event, and each staged tensor is recorded
    on that stream, so the caching allocator keeps its block from the
    copy stream until the kernels that read it are done.  A retried call
    takes the same tensors again."""
    with span('hicpeaks.h2d'):
        staged = getattr(bands, '_staged', None)
        if staged is None or staged.device != _indexed(device):
            return bands_to_device(bands, device)
        if staged.event is not None:
            stream = torch.cuda.current_stream(staged.device)
            stream.wait_event(staged.event)
            for t in staged.tensors.values():
                t.record_stream(stream)
        return dict(staged.tensors)


def _chunk_margin(plan):
    """Provable |t_f32 - t_f64| bound for t = 3*log2(E): the
    cancellation-free ring accumulation plus the ratio/EM/Bprod
    arithmetic, dt = 3/ln2 * relE, and a pad for the f32 log."""
    maxw = max(e.w for e in plan)
    cells = (2 * maxw + 1) ** 2
    return 3.0 / 0.6931471805599453 * (3 * cells + 8) * 2.0 ** -24 + 5e-5


def _bh_plan(max_count):
    """The histogram-BH count cap ``o_cap``, a power of two >= 1024 and >=
    the chromosome's max count, or None above :data:`_MAX_O_CAP` (the
    chunked scorer then takes segmented BH)."""
    if max_count > _MAX_O_CAP:
        return None
    o_cap = 1024
    while o_cap < int(max_count):
        o_cap *= 2
    return o_cap


class Route(NamedTuple):
    """One chromosome's route through the engine (:func:`resolve_route`)."""
    scan: str          # 'kernel' or 'validate'
    device_gate: bool  # the fused route: the freeze gate on the device
    batched: bool      # the fused route's scorer serves every background
    bh: str            # 'device' or 'host'
    o_cap: object      # histogram count cap; None: no histogram BH
    check: bool        # checkify: the per-background scorer with checks


def resolve_route(scan_backend, bh_backend, check, total, max_count=None,
                  mesh=None):
    """The route of ``hicpeaks_tpu``'s ``_resolve_scan_impl`` and
    ``_bh_plan`` (``engine.py:609-625,900-925``) as JAX takes it on a
    backend that is not a TPU.  ``max_count`` is None for pyBHFDR, whose
    global BH has no count cap.

    * ``scan_backend`` 'auto', 'pallas', 'jnp' and 'pallas-interpret'
      run the scan kernels' wrappers (``ops/cuda_scan.py``): the CUDA
      kernels on the card, the plain twins only for CPU tensors.  JAX's
      'jnp' names its plain path because JAX off a TPU has no other; the
      port has its kernels, and they are bit-equal to the twins.
      'validate' runs kernel and twin on the same inputs, asserts that
      they are bit-equal, and takes the host-gate route.
    * ``bh_backend`` 'auto' is 'device': histogram BH up to the count cap,
      device segmented BH above it (pyHICCUPS), the sort-free global BH
      (pyBHFDR); 'host' is the dense scorer with float64 BH on the host.
    * ``check`` takes the per-background scorer with device BH.
    * A candidate total with ``10 * total >= _GATE_LIMIT`` takes the
      host gate, and so does every route on a ``mesh`` (JAX's fused route
      tests ``mesh is None``, ``engine.py:1401,1505``)."""
    if scan_backend not in SCAN_BACKENDS:
        raise ValueError(f'scan_backend {scan_backend!r} not in '
                         f'{SCAN_BACKENDS}')
    if bh_backend not in BH_BACKENDS:
        raise ValueError(f'bh_backend {bh_backend!r} not in {BH_BACKENDS}')
    scan = 'validate' if scan_backend == 'validate' else 'kernel'
    bh = 'host' if bh_backend == 'host' else 'device'
    o_cap = None
    if max_count is not None and bh == 'device':
        o_cap = _bh_plan(max_count)
    batched = (not check and bh == 'device'
               and (max_count is None or o_cap is not None))
    device_gate = (batched and scan != 'validate' and mesh is None
                   and 10 * total < _GATE_LIMIT)
    return Route(scan, device_gate, batched, bh, o_cap, bool(check))


def _validated(kernel, twin, name):
    """``kernel`` and ``twin`` on the same inputs, asserted bit-equal
    (``engine.py:1295-1302,1325-1345``); returns the kernel's result."""
    def run(*args):
        a, b = kernel(*args), twin(*args)
        pairs = ([(a, b, '')] if isinstance(a, torch.Tensor) else
                 [(a[p][t], b[p][t], f' p={p} {n}') for p in a
                  for t, n in enumerate(('KS', 'KE', 'YS', 'YE'))])
        for x, y, what in pairs:
            if not torch.equal(x, y):
                raise AssertionError(f'{name} backend mismatch{what}')
        return a
    return run


def _scan_calls(scan):
    """(pass A, pass B) of a route's ``scan``; pass B returns {p: [KS, KE,
    YS, YE]}."""
    def twin_b(*a):
        return scan_ops.scan_pass_b(*a)[2]
    if scan == 'validate':
        return (_validated(cuda_scan.scan_pass_a, scan_ops.scan_pass_a,
                           'pass A'),
                _validated(cuda_scan.scan_pass_b, twin_b, 'pass B'))
    return cuda_scan.scan_pass_a, cuda_scan.scan_pass_b


def _check_finite(**named):
    """checkify's float checks, at the port's stage boundaries: raise
    FloatingPointError naming the first tensor that holds a NaN and its
    first NaN's index."""
    for name, t in named.items():
        bad = torch.isnan(t)
        with span(SYNC):
            found = bool(bad.any())
        if found:
            at = tuple(torch.nonzero(bad)[0].tolist())
            raise FloatingPointError(f'checkify: NaN in {name} at {at}')


def _check_in_band(cnt, d_idx, x_idx, num_p, L):
    """checkify's index checks on the compaction: every compacted (d, x)
    of each background's first ``cnt`` entries lies inside the band (d <
    num_p and x + d < L); raise IndexError naming the first that does
    not."""
    for b in range(d_idx.shape[0]):
        with span(SYNC):
            n = int(cnt[b])
        d, x = d_idx[b, :n].to(torch.int64), x_idx[b, :n].to(torch.int64)
        bad = (d < 0) | (d >= num_p) | (x < 0) | (x + d >= L)
        with span(SYNC):
            found = bool(bad.any())
        if found:
            k = int(torch.nonzero(bad)[0])
            raise IndexError(f'checkify: compacted pixel (d, x) = '
                             f'({int(d[k])}, {int(x[k])}) of background {b} '
                             f'lies outside the band of {num_p} diagonals '
                             f'and length {L}')


class Sheets(NamedTuple):
    """The device sheets of one chromosome (``score_ops.build_sheets``)."""
    raw: torch.Tensor
    cband: torch.Tensor
    eband: torch.Tensor
    IR: torch.Tensor
    Bprod: torch.Tensor
    gap_drop: torch.Tensor
    cand: torch.Tensor
    L: int


def _scan_front(ops, bands, plan, p_list, thr, d_lo, d_hi, gap_s, route,
                replay, device_gate):
    """The front every route shares: the sheets, pass A, the freeze gate,
    pass B.  The gate is ``device_gate`` (pass A's counts -> the device
    bool [n_entries] ``allowed``) on the fused route; elsewhere the counts
    are fetched and ``replay``ed on the host in Python integers (counts ->
    FreezeDecision) and the decision is sent back.  The device gate is
    held to the host replay.  Returns (sheets, {p: [KS, KE, YS, YE]},
    FreezeDecision)."""
    L = int(bands.L)
    with span('hicpeaks.sheets'):
        raw, cband, eband, Bprod, gap_drop, cand = score_ops.build_sheets(
            ops['raw'], ops['w0'], ops['bias'], ops['IR'], ops['gap'],
            bands.ww_min, L, d_lo, d_hi, gap_s)
    sh = Sheets(raw, cband, eband, ops['IR'], Bprod, gap_drop, cand, L)
    if route.check:
        _check_finite(raw=raw, cband=cband, eband=eband, Bprod=Bprod)
    pass_a, pass_b = _scan_calls(route.scan)
    with span('hicpeaks.scan'):
        counts = pass_a(raw, cand, plan, p_list, thr)
        if route.device_gate:
            allowed = device_gate(counts)
        else:
            decision = _replayed(replay, counts)
            allowed = torch.tensor(decision.allowed, dtype=torch.bool,
                                   device=raw.device)
        outs = pass_b(raw, cband, eband, cand, allowed, plan, p_list, thr)
    if route.check:
        _check_finite(**{f'pass B {n} (p={p})': v for p, o in outs.items()
                         for n, v in zip(('KS', 'KE', 'YS', 'YE'), o)})
    if route.device_gate:
        counts_h, allowed_h = _to_host((counts, allowed))
        with span('hicpeaks.replay'):
            decision = replay(counts_h)
        if not np.array_equal(allowed_h, np.asarray(decision.allowed)):
            raise AssertionError(
                'device freeze emulation diverged from the host replay')
    return sh, outs, decision


def _replayed(replay, counts):
    """The host gate: pass A's ``counts`` fetched and ``replay``ed."""
    counts_h = _to_host(counts)
    with span('hicpeaks.replay'):
        return replay(counts_h)


def _exact_capable(bands):
    """Whether the bands carry the float64 vectors and the host raw slab
    that float64 completion reads: the whole slab, or this process's
    column spans of bands ingested per process (their window cells are
    summed exactly across processes, ``ops/hostexact``)."""
    return (getattr(bands, 'w064', None) is not None
            and (isinstance(getattr(bands, 'raw', None), np.ndarray)
                 or getattr(bands, 'raw_spans', None) is not None))


def _exact_ctx(bands, plan, allowed, thr):
    """ExactCtx for float64 host completion, or None without it."""
    if not _exact_capable(bands):
        return None
    return ExactCtx(bands, plan, allowed, thr)


def _gather_flat_b(a, d, x):
    """a[b, d[b, k], x[b, k]] over a [B, num_p, Lp] sheet."""
    B, _, Lp = a.shape
    return torch.gather(a.reshape(B, -1), 1,
                        (d.to(torch.int64) * Lp + x))


def _gather_flat_shared(a, d, x):
    """a[d[b, k], x[b, k]] over a shared [num_p, Lp] sheet."""
    return a.reshape(-1)[d.to(torch.int64) * a.shape[1] + x]


def _observe_batched(sh, BSV, BEV, wis_t, c0=0, check=False):
    """The batched scorer's first stage over B backgrounds: E, O, ICE,
    Fold, the scored mask, prod [B, num_p, Lp] and the lambda chunks (cid,
    valid).  ``c0``: the sheets' first chromosome column (a tile's)."""
    E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
        sh.raw, sh.cband, sh.IR, sh.Bprod, BSV, BEV, wis_t[:, None, None],
        sh.cand, sh.L, c0=c0)
    if check:
        _check_finite(E=E, O=O, ICE=ICE, Fold=Fold)
    cid, _rv, valid = score_ops.lambda_chunks(E, scored)
    return E, O, ICE, Fold, scored, prod, cid, valid


def _keep_batched(sh, obs, thr2, sig, o_cap, exact_mode, margin,
                  check=False):
    """The batched scorer's second stage, from the keep thresholds ``thr2``
    [B, S] of the (summed) histogram: the keep mask (BH, gap filter, and
    with ``exact_mode`` the lambda-chunk edge suspects set aside) and its
    row-major compaction.  Returns the :class:`Compacted` without the
    histogram: its ``hist`` and its suspects' ``thr`` are None."""
    E, O, ICE, Fold, scored, prod, cid, valid = obs
    keep = scored & score_ops.chunk_keep(O, cid, valid, thr2, sig,
                                         o_cap + 1) & ~sh.gap_drop
    gb, gu = _gather_flat_b, _gather_flat_shared
    sus = None
    if exact_mode:
        is_sus = score_ops.lambda_suspects(E, scored, margin)
        keep = keep & ~is_sus
        cnt_s, d_s, x_s = score_ops.compact_mask_batched(is_sus)
        sus = Suspects(
            cnt_s, d_s, x_s,
            cid=torch.where(gb(valid, d_s, x_s), gb(cid, d_s, x_s), 0),
            O=torch.clamp(torch.floor(gu(O, d_s, x_s)), 0, o_cap)
            .to(torch.int32),
            gap=gu(sh.gap_drop, d_s, x_s), thr=None)
    cnt, d_idx, x_idx = score_ops.compact_mask_batched(keep)
    if check:
        _check_in_band(cnt, d_idx, x_idx, O.shape[0], sh.L)
    return Compacted(
        cnt, d_idx, x_idx, O=gu(O, d_idx, x_idx), ICE=gu(ICE, d_idx, x_idx),
        Fold=gb(Fold, d_idx, x_idx),
        cid=torch.where(gb(valid, d_idx, x_idx), gb(cid, d_idx, x_idx), 0),
        hist=None, prod=prod, sus=sus)


def _compact_batched(sh, SV, EV, wis, sig, o_cap, exact_mode, margin,
                     s_rows, check=False):
    """All B backgrounds (every (p, w) pair x {K, Y}, or one) scored in
    one batched body: expected values, lambda chunks, histogram BH keep
    mask (one histogram launch for all B), gap filter and compaction.
    ``SV``, ``EV``: each background's capture planes [num_p, Lp]; ``wis``:
    its window radius.  Where ``cuda_score.serves``, the dense stages are
    the fused kernels (:func:`_compact_fused`), else the eager chain.

    Returns the :class:`Compacted`, its prod [B, num_p, Lp] or its
    ``cuda_score.PlaneProd`` handle, its suspects None without
    ``exact_mode``."""
    with span('hicpeaks.score'):
        if cuda_score.serves(sh, SV, EV, check):
            with span('hicpeaks.score_fused'):
                return _compact_fused(sh, SV, EV, wis, sig, o_cap,
                                      exact_mode, margin, s_rows)
        wis_t = torch.tensor(wis, dtype=torch.int32, device=sh.raw.device)
        obs = _observe_batched(sh, torch.stack(SV), torch.stack(EV), wis_t,
                               check=check)
        O, cid, valid = obs[1], obs[6], obs[7]
        B, S, C = cid.shape[0], s_rows, o_cap + 1
        oc, cid0 = score_ops.chunk_pack(O, cid, valid, S, C)
        hist = score_ops.chunk_hist(oc, cid0, S, C)             # [B*S, C]
        _qtab, thr2 = score_ops.chunk_thresholds(hist, B, S, sig, _BH_SLACK,
                                                 O.dtype)
        kept = _keep_batched(sh, obs, thr2, sig, o_cap, exact_mode, margin,
                             check)
        return kept._replace(hist=hist.reshape(B, S, C), sus=kept.sus and
                             kept.sus._replace(thr=thr2.to(torch.int32)))


def _compact_fused(sh, SV, EV, wis, sig, o_cap, exact_mode, margin, s_rows):
    """:func:`_compact_batched`'s record through the fused kernels
    (``ops/cuda_score``): one pass for the histogram's inputs and the
    flags, the histogram and its thresholds as on the eager chain, the
    keep and suspect masks, their compactions, and the compacted pixels'
    values recomputed from the planes."""
    B, S, C = len(SV), s_rows, o_cap + 1
    oc, cid0, flags = cuda_score.score_observe(sh, SV, EV, wis, margin, S,
                                               C)
    hist = score_ops.chunk_hist(oc, cid0, S, C)                 # [B*S, C]
    _qtab, thr2 = score_ops.chunk_thresholds(hist, B, S, sig, _BH_SLACK,
                                             sh.raw.dtype)
    keep, is_sus = cuda_score.score_keep(sh.raw, sh.gap_drop, cid0, flags,
                                         thr2, sig, C, exact_mode)
    del oc, cid0, flags
    sus = None
    if exact_mode:
        cnt_s, d_s, x_s = score_ops.compact_mask_batched(is_sus)
    cnt, d_idx, x_idx = score_ops.compact_mask_batched(keep)
    O, ICE, Fold, cid, *at_sus = cuda_score.score_gather(
        sh, SV, EV, wis, (d_idx, x_idx), (d_s, x_s) if exact_mode else None,
        C, prod=False)
    if exact_mode:
        sus = Suspects(cnt_s, d_s, x_s, *at_sus, thr=thr2.to(torch.int32))
    return Compacted(cnt, d_idx, x_idx, O, ICE, Fold, cid,
                     hist=hist.reshape(B, S, C),
                     prod=cuda_score.PlaneProd(sh, SV, EV, wis, C), sus=sus)


def _score_device_bhfdr_compact(sh, bSV, bEV, sig, wi, check=False):
    """Global-BH scoring of the donut background: p-values, the sort-free
    keep superset (``score_ops.global_bh_keep``) and its row-major
    compaction.  Gap pixels stay in the superset: the gap filter comes
    after BH, on the host.

    Returns the 11-slot bundle (cnt, d, x, O, ICE, Fold, p, E, m, gap,
    prod)."""
    with span('hicpeaks.score'):
        E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
            sh.raw, sh.cband, sh.IR, sh.Bprod, bSV, bEV, wi, sh.cand, sh.L)
        pval = torch.where(scored, score_ops.poisson_sf(O, E), 1.0)
        if check:
            _check_finite(E=E, O=O, ICE=ICE, Fold=Fold, p=pval)
        keep_sup, m, _ = score_ops.global_bh_keep(pval, scored, sig)
        cnt, d_idx, x_idx = score_ops.compact_mask(keep_sup)
        if check:
            _check_in_band(cnt[None], d_idx[None], x_idx[None], O.shape[0],
                           sh.L)
        small = [_gather_flat_shared(a, d_idx, x_idx)
                 for a in (O, ICE, Fold, pval, E, sh.gap_drop)]
        return (cnt, d_idx, x_idx, *small[:5], m, small[5], prod)


def _score_device_segmented(sh, bSV, bEV, sig, wi, check=False):
    """The chunked scorer without a count cap (``_compact_one`` with
    ``o_cap`` None): lambda chunks, device p at each chunk's right edge,
    segmented BH by a sort, the gap filter and the row-major compaction.
    Returns the 8-slot bundle (cnt, d, x, O, ICE, Fold, p, q) and prod."""
    with span('hicpeaks.score'):
        E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
            sh.raw, sh.cband, sh.IR, sh.Bprod, bSV, bEV, wi, sh.cand, sh.L)
        cid, rv, valid = score_ops.lambda_chunks(E, scored)
        # JAX's right edge is weakly typed, so its p takes O's float32
        # whatever the bands' dtype: p and q are float32 igamma values, and
        # XLA flushes float32 subnormals to zero
        pval = score_ops.poisson_sf(O, rv.to(O.dtype))
        pval = torch.where(valid & (pval >= torch.finfo(pval.dtype).tiny),
                           pval, torch.where(valid, 0.0, 1.0))
        qval = score_ops.segmented_bh(pval, cid, valid)
        if check:
            _check_finite(E=E, O=O, ICE=ICE, Fold=Fold, p=pval, q=qval)
        keep = scored & (qval <= sig) & ~sh.gap_drop
        cnt, d_idx, x_idx = score_ops.compact_mask(keep)
        if check:
            _check_in_band(cnt[None], d_idx[None], x_idx[None], O.shape[0],
                           sh.L)
        small = tuple(_gather_flat_shared(a, d_idx, x_idx)
                      for a in (O, ICE, Fold, pval, qval))
        return (cnt, d_idx, x_idx) + small, prod


def _score_dense(sh, bSV, bEV, sig, wi, chunked):
    """The dense scorer (``_score_device`` with ``with_bh=False`` and the
    host branches of ``_score_one``): every valid pixel of the background
    fetched in row-major order, float64 BH on the host
    (``hostcomplete._dense_to_host``)."""
    with span('hicpeaks.score'):
        E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
            sh.raw, sh.cband, sh.IR, sh.Bprod, bSV, bEV, wi, sh.cand, sh.L)
        if chunked:
            cid, _rv, valid = score_ops.lambda_chunks(E, scored)
        else:
            cid, valid = torch.ones_like(scored, dtype=torch.int32), scored
        _, d_idx, x_idx = score_ops.compact_mask(valid)
        small = tuple(_gather_flat_shared(a, d_idx, x_idx)
                      for a in (O, ICE, Fold, cid, E, sh.gap_drop))
    fetched = _to_host((d_idx, x_idx) + small)
    return _dense_to_host(fetched, prod, sig, chunked)


def _score_one(sh, bSV, bEV, wi, sig, route, chunked, exact=None):
    """One background through the per-background scorer
    (``engine.py:1165-1259``); returns its host dict.  Device BH first
    (checkify forces it): global BH (pyBHFDR), segmented BH without a
    count cap, or histogram BH at B = 1 (checkify's pyHICCUPS scorer,
    exact completion without the suspect bundle, so no audit); the dense
    host scorer for ``bh='host'``."""
    if route.check or route.bh == 'device':
        if not chunked:
            out = _score_device_bhfdr_compact(sh, bSV, bEV, sig, wi,
                                              route.check)
            return _bhfdr_to_host(_to_host(out[:10]), out[10], sig,
                                  exact=exact)
        if route.o_cap is None:
            out, prod = _score_device_segmented(sh, bSV, bEV, sig, wi,
                                                route.check)
            return _segmented_to_host(_to_host(out), prod)
        out = _compact_batched(
            sh, [bSV], [bEV], [wi], sig, route.o_cap,
            exact_mode=False, margin=0.0,
            s_rows=score_ops.chunk_rows(route.o_cap, sig), check=route.check)
        fetched = one_background(_to_host(out._replace(prod=None)), 0)
        return _compact_to_host(fetched, (out.prod, 0), sig, exact=exact)
    return _score_dense(sh, bSV, bEV, sig, wi, chunked)


def _to_host(tree):
    """Tensors -> numpy arrays through nested tuples (a record keeps its
    type, None stays None), one blocking read (a ``hicpeaks.sync`` span) a
    tensor."""
    if isinstance(tree, tuple):
        got = tuple(map(_to_host, tree))
        return tree._make(got) if hasattr(tree, '_make') else got
    if tree is None:
        return None
    with span(SYNC):
        return tree.cpu().numpy()


def _hiccups_scored(bands: ChromBands, cfg: HiccupsConfig, plan, p_list,
                    pairs, total, route, device):
    """One chromosome through its route, completed to per-pair (rK, rY)
    host dicts: the front, then the batched scorer where the route takes
    it, completed on the device with float64 completion
    (:mod:`.complete64`) and else on the host, and :func:`_score_dense`
    for each background whose suspect audit fails; off the batched route,
    :func:`_score_one` for every background."""
    ww = tuple(cfg.ww)
    t_left = poolplan.left_threshold(total)
    sh, outs, decision = _scan_front(
        _staged_operands(bands, device), bands, plan, p_list,
        cfg.min_local_reads, min(ww), cfg.maxapart // bands.res, min(ww),
        route,
        lambda c: poolplan.emulate_freeze_hiccups(plan, c, total, ww),
        lambda c: poolplan.device_allowed_hiccups(c, total, t_left, plan, ww))
    ctx = _exact_ctx(bands, plan, decision.allowed, cfg.min_local_reads)
    margin = _chunk_margin(plan)
    # background b: pair b % n, donut 'K' (captures 0, 1) for b < n, else
    # lower-left 'Y' (captures 2, 3)
    n = len(pairs)
    bgs = [(int(p), int(w), k, t) for k, t in (('K', 0), ('Y', 2))
           for p, w in pairs]
    res = [None] * (2 * n)
    if route.batched:
        out = _compact_batched(
            sh, [outs[p][t] for p, _, _, t in bgs],
            [outs[p][t + 1] for p, _, _, t in bgs],
            [w for _, w, _, _ in bgs], cfg.siglevel, route.o_cap,
            exact_mode=ctx is not None, margin=margin,
            s_rows=score_ops.chunk_rows(route.o_cap, cfg.siglevel))
        if ctx is not None:
            res = complete_on_device(sh, out, bgs, ctx, cfg.siglevel)
        else:
            fetched = _to_host(out._replace(prod=None))
            res = [_compact_to_host(one_background(fetched, b),
                                    (out.prod, b), cfg.siglevel)
                   for b in range(len(bgs))]
    for b, (p, w, kind, t) in enumerate(bgs):
        if res[b] is not None:
            continue
        if route.batched:
            # the batched audit failed: a histogram scorer at B = 1 would
            # repeat it, so this background goes straight to the dense one
            with span('hicpeaks.dense_fallback'):
                res[b] = _score_dense(sh, outs[p][t], outs[p][t + 1],
                                      cfg.siglevel, w, chunked=True)
        else:
            res[b] = _score_one(sh, outs[p][t], outs[p][t + 1], w,
                                cfg.siglevel, route, chunked=True,
                                exact=ctx and (ctx, p, kind))
    return [(res[i], res[n + i]) for i in range(n)]


class TileSheets(NamedTuple):
    """The sheets of one chromosome as the mesh's column tiles: one
    :class:`Sheets` a tile, on the tile's device (None for other
    processes' tiles), each ``T`` columns wide."""
    tiles: list
    T: int
    mesh: object
    L: int


def _mesh_sheets(bands, mesh, d_lo, d_hi, gap_s, ir_backend):
    """The tiles' sheets.  Bands built whole (``ops/band``) go to the
    mesh's first device, their sheets are built there whole and cut into
    tiles (JAX ``_prep_chrom``, ``engine.py:208-240``).  Bands ingested
    per process (``parallel/multihost.sharded_bands_from_cooler``) hold
    only this process's tiles: each tile's sheets are built on its device
    from its raw slab and the whole chromosome's vectors.
    ``ir_backend='device'`` replaces the host's IR with
    ``tiles.ir_sharded`` over the raw tiles."""
    L, n = int(bands.L), mesh.size
    spans = getattr(bands, 'raw_spans', None)
    if ir_backend not in ('host', 'device'):
        raise ValueError(f"ir_backend {ir_backend!r} not in ('host', "
                         "'device')")

    def ir_on(raw_t):
        if ir_backend == 'host':
            return torch.as_tensor(bands.IR, device=mesh.first_device)
        return tiles.ir_sharded(raw_t, bands.w0, bands.nanw, L,
                                bands.ww_min, bands.num, mesh)

    cut = [None] * n
    if spans is None:
        ops = bands_to_device(bands, mesh.first_device)
        if ir_backend == 'device':
            ops['IR'] = ir_on(tiles.shard_band(ops['raw'], mesh))
        IR = ops['IR']
        T = tiles.tile_width(ops['raw'].shape[1], n)
        whole = score_ops.build_sheets(
            ops['raw'], ops['w0'], ops['bias'], IR, ops['gap'],
            bands.ww_min, L, d_lo, d_hi, gap_s)
        parts = [tiles.shard_band(a, mesh) for a in whole]
        del whole
        for i in mesh.local_tiles:
            raw, cband, eband, Bprod, gap_drop, cand = (p[i] for p in parts)
            cut[i] = Sheets(raw, cband, eband, IR.to(mesh.devices[i]), Bprod,
                            gap_drop, cand, L)
    else:
        T = bands.raw_shape[1] // n
        want = {(i * T, (i + 1) * T) for i in mesh.local_tiles}
        if set(spans) != want or T * n != bands.raw_shape[1]:
            raise ValueError(f'the bands hold column spans {sorted(spans)}; '
                             f'this process\'s tiles of the mesh are '
                             f'{sorted(want)}')
        raw_t = [None] * n
        for i in mesh.local_tiles:
            raw_t[i] = torch.as_tensor(spans[(i * T, (i + 1) * T)],
                                       device=mesh.devices[i])
        IR = ir_on(raw_t)
        for i in mesh.local_tiles:
            dev = mesh.devices[i]
            vec = {k: torch.as_tensor(np.ascontiguousarray(getattr(bands, k)),
                                      device=dev)
                   for k in ('w0', 'bias', 'gap')}
            IR_i = IR.to(dev)
            raw, cband, eband, Bprod, gap_drop, cand = score_ops.build_sheets(
                raw_t[i], vec['w0'], vec['bias'], IR_i, vec['gap'],
                bands.ww_min, L, d_lo, d_hi, gap_s, c0=i * T)
            cut[i] = Sheets(raw, cband, eband, IR_i, Bprod, gap_drop, cand, L)
    return TileSheets(cut, T, mesh, L)


def _mesh_front(bands, mesh, plan, p_list, thr, d_lo, d_hi, gap_s, route,
                replay, ir_backend):
    """:func:`_scan_front` on the mesh's tiles: the tiles' sheets, pass A
    on every tile (counts summed), the freeze gate replayed on the host,
    pass B on every tile.  Returns (TileSheets, per tile {p: [KS, KE, YS,
    YE]}, FreezeDecision)."""
    with span('hicpeaks.sheets'):
        ts = _mesh_sheets(bands, mesh, d_lo, d_hi, gap_s, ir_backend)
    pass_a, pass_b = _scan_calls(route.scan)

    def field(k):
        return [sh and sh[k] for sh in ts.tiles]

    raw, cand = field(0), field(6)
    with span('hicpeaks.scan'):
        counts = tiles.scan_pass_a_sharded(raw, cand, plan, p_list, thr,
                                           mesh, pass_a)
        decision = _replayed(replay, counts)
        allowed = torch.tensor(decision.allowed, dtype=torch.bool)
        outs = tiles.scan_pass_b_sharded(raw, field(1), field(2), cand,
                                         allowed, plan, p_list, thr, mesh,
                                         pass_b)
    return ts, outs, decision


def _gathered(ts, outs_t, route):
    """The whole chromosome's sheets and captures on the mesh's first
    device, gathered from the tiles, for the single-device scorers of the
    routes that need the whole chromosome at once (segmented BH's sort,
    the dense scorer's host BH, checkify's checks, which run here)."""
    mesh = ts.mesh

    def g(parts):
        return tiles.gather_tiles(parts, mesh)

    first = ts.tiles[mesh.local_tiles[0]]
    sh = Sheets(*(g([t and t[k] for t in ts.tiles]) for k in range(3)),
                first.IR,
                *(g([t and t[k] for t in ts.tiles]) for k in range(4, 7)),
                ts.L)
    outs = {p: [g([o and o[p][t] for o in outs_t]) for t in range(4)]
            for p in outs_t[mesh.local_tiles[0]]}
    if route.check:
        _check_finite(raw=sh.raw, cband=sh.cband, eband=sh.eband,
                      Bprod=sh.Bprod)
        _check_finite(**{f'pass B {n} (p={p})': v for p, o in outs.items()
                         for n, v in zip(('KS', 'KE', 'YS', 'YE'), o)})
    return sh, outs


def _hiccups_tiles(ts, outs_t, bgs, sig, o_cap, ctx, margin):
    """The batched pyHICCUPS scorer on the tiles: each tile's first stage
    (:func:`_observe_batched`), one histogram launch a tile with the
    histograms summed (``tiles.chunk_hist_sharded``), the keep thresholds
    of the summed histogram, each tile's second stage
    (:func:`_keep_batched`), and the tiles' compactions and suspects
    merged in row-major order.  Unlike JAX's mesh route, which sets no
    lambda-chunk edge suspect aside (``engine.py:757,1051``), the tiles
    keep exact mode: the float64 completion corrects the suspects as on
    one device, so the mesh table is the single-device table.  Returns one
    host dict per background of ``bgs`` (None where the suspect audit
    fails)."""
    mesh = ts.mesh
    S, C = score_ops.chunk_rows(o_cap, sig), o_cap + 1
    B = len(bgs)
    exact_mode = ctx is not None
    obs = [None] * mesh.size
    with span('hicpeaks.score'):
        for i in mesh.local_tiles:
            BSV = torch.stack([outs_t[i][p][t] for p, _, _, t in bgs])
            BEV = torch.stack([outs_t[i][p][t + 1] for p, _, _, t in bgs])
            wis = torch.tensor([w for _, w, _, _ in bgs], dtype=torch.int32,
                               device=mesh.devices[i])
            obs[i] = _observe_batched(ts.tiles[i], BSV, BEV, wis,
                                      c0=i * ts.T)
        hist = tiles.chunk_hist_sharded(
            [o and o[1] for o in obs], [o and o[6] for o in obs],
            [o and o[7] for o in obs], S, C, mesh)
        _qtab, thr2 = score_ops.chunk_thresholds(
            hist, B, S, sig, _BH_SLACK, obs[mesh.local_tiles[0]][1].dtype)
        # each tile's pixels cut to their counts, x tile-local
        rows, rows_s = ('d', 'x', 'O', 'ICE', 'Fold', 'cid'), \
            ('d', 'x', 'cid', 'O', 'gap')
        parts, parts_s, prods = [], [], [None] * mesh.size
        for i in mesh.local_tiles:
            kept = _keep_batched(ts.tiles[i], obs[i],
                                 thr2.to(mesh.devices[i]), sig, o_cap,
                                 exact_mode, margin)
            prods[i] = kept.prod
            obs[i] = None
            h = _to_host(kept._replace(prod=None))
            for rec, names, out in ((h, rows, parts),
                                    (h.sus, rows_s, parts_s)):
                if rec is not None:
                    out.append((i * ts.T, [
                        tuple(getattr(rec, f)[b][:rec.cnt[b]] for f in names)
                        for b in range(B)]))
        merged = tiles.merge_rowmajor(parts, mesh)
        merged_s = tiles.merge_rowmajor(parts_s, mesh) if exact_mode else None
        hist_b = _to_host(hist).reshape(B, S, C)
        thr_h = _to_host(thr2.to(torch.int32))
    prod = tiles.TiledSheet(prods, mesh)
    res = []
    for b, (p, _, kind, _) in enumerate(bgs):
        sus = None
        if exact_mode:
            sus = Suspects(cnt=len(merged_s[b][0]),
                           **dict(zip(rows_s, merged_s[b])), thr=thr_h[b])
        fetched = Compacted(cnt=len(merged[b][0]),
                            **dict(zip(rows, merged[b])), hist=hist_b[b],
                            prod=None, sus=sus)
        res.append(_compact_to_host(fetched, (prod, b), sig,
                                    exact=ctx and (ctx, p, kind)))
    return res


def _bhfdr_tiles(ts, outs_t, pw, wi, sig, exact):
    """The pyBHFDR scorer on the tiles: each tile's E, O and float32 p,
    the global-BH fixed point with each step's count summed over the
    tiles (``tiles.psum``), each tile's compaction, merged in row-major
    order; then float64 completion (``_bhfdr_to_host``)."""
    mesh = ts.mesh
    obs, pvals, scoreds = {}, [], []
    with span('hicpeaks.score'):
        for i in mesh.local_tiles:
            sh = ts.tiles[i]
            E, O, ICE, Fold, scored, prod = score_ops.expected_observed(
                sh.raw, sh.cband, sh.IR, sh.Bprod, outs_t[i][pw][0],
                outs_t[i][pw][1], wi, sh.cand, sh.L, c0=i * ts.T)
            pval = torch.where(scored, score_ops.poisson_sf(O, E), 1.0)
            obs[i] = (O, ICE, Fold, pval, E, sh.gap_drop, prod)
            pvals.append(pval)
            scoreds.append(scored)
        keep, m, _ = score_ops.global_bh_keep(
            pvals, scoreds, sig, count_sum=lambda c: tiles.psum(c, mesh))
        parts, prods = [], [None] * mesh.size
        for k, i in enumerate(mesh.local_tiles):
            *sheets, prods[i] = obs.pop(i)
            _cnt, d, x = score_ops.compact_mask(keep[k])
            h = _to_host((d, x) + tuple(_gather_flat_shared(a, d, x)
                                        for a in sheets))
            parts.append((i * ts.T, [h]))
        d, x, O, ICE, Fold, p, E, gap = tiles.merge_rowmajor(parts, mesh)[0]
        m_h = _to_host(m)
    return _bhfdr_to_host((len(d), d, x, O, ICE, Fold, p, E, m_h, gap),
                          tiles.TiledSheet(prods, mesh), sig, exact=exact)


def _mesh_hiccups_scored(bands, cfg, plan, p_list, pairs, total, route,
                         mesh, ir_backend):
    """:func:`_hiccups_scored` on the mesh's tiles: the batched route on
    the tiles (:func:`_hiccups_tiles`; a background whose suspect audit
    fails goes to the dense scorer), every other route on the gathered
    chromosome (:func:`_gathered`, then :func:`_score_one`)."""
    ww = tuple(cfg.ww)
    ts, outs_t, decision = _mesh_front(
        bands, mesh, plan, p_list, cfg.min_local_reads, min(ww),
        cfg.maxapart // bands.res, min(ww), route,
        lambda c: poolplan.emulate_freeze_hiccups(plan, c, total, ww),
        ir_backend)
    ctx = _exact_ctx(bands, plan, decision.allowed, cfg.min_local_reads)
    n = len(pairs)
    bgs = [(int(p), int(w), k, t) for k, t in (('K', 0), ('Y', 2))
           for p, w in pairs]
    res = [None] * (2 * n)
    if route.batched:
        res = _hiccups_tiles(ts, outs_t, bgs, cfg.siglevel, route.o_cap, ctx,
                             _chunk_margin(plan))
    sh = None
    for b, (p, w, kind, t) in enumerate(bgs):
        if res[b] is not None:
            continue
        if sh is None:
            sh, outs = _gathered(ts, outs_t, route)
        if route.batched:
            with span('hicpeaks.dense_fallback'):
                res[b] = _score_dense(sh, outs[p][t], outs[p][t + 1],
                                      cfg.siglevel, w, chunked=True)
        else:
            res[b] = _score_one(sh, outs[p][t], outs[p][t + 1], w,
                                cfg.siglevel, route, chunked=True,
                                exact=ctx and (ctx, p, kind))
    return [(res[i], res[n + i]) for i in range(n)]


def _gather_prod(prod, pixels):
    """Postcheck values at (x, y) ``pixels`` of a ``prod`` handle: a
    (stacked [B, num_p, Lp], b) pair from a batched scorer or a plain
    [num_p, Lp] sheet (``engine.py:799-805``), as numpy."""
    stacked, i = prod if isinstance(prod, tuple) else (prod[None], 0)
    if isinstance(stacked, (tiles.TiledSheet, cuda_score.PlaneProd)):
        return stacked.gather(i, [y - x for x, y in pixels],
                              [x for x, _ in pixels])
    di = torch.tensor([y - x for x, y in pixels], dtype=torch.int64,
                      device=stacked.device)
    xi = torch.tensor([x for x, _ in pixels], dtype=torch.int64,
                      device=stacked.device)
    vals = stacked[i, di, xi]
    with span(SYNC):
        return vals.cpu().numpy()


def _merge_pairs(results, pairs, cfg, res):
    """The per-pair (rK, rY) host dicts merged into one table {(x_bp,
    y_bp): (x_bp, y_bp, 0, first, O, FoldK, pK, qK, FoldY, pY, qY)}: the
    donut pixels kept by the lower-left background or by its postcheck,
    through the fold gates, a later pair replacing an entry only with
    lower q-values in both backgrounds."""
    pixel_table = {}
    for pair_idx, (pi, wi) in enumerate(pairs):
        with span('hicpeaks.pair_merge'):
            rK, rY = results[pair_idx]

            first = rK['O'] if cfg.use_raw else rK['ICE']
            preDonuts = {(int(x), int(y)): (fi, o, f, p, q)
                         for x, y, fi, o, f, p, q in zip(
                             rK['x'], rK['y'], first, rK['O'], rK['Fold'],
                             rK['p'], rK['q'])}
            preLL = {(int(x), int(y)): (i, o, f, p, q)
                     for x, y, i, o, f, p, q in zip(
                         rY['x'], rY['y'], rY['ICE'], rY['O'], rY['Fold'],
                         rY['p'], rY['q'])}

            commonPos = set(preDonuts) & set(preLL)
            postcheck = set(preDonuts) - set(preLL)
            if postcheck:
                # cEM here is the Y background's expected matrix (the
                # reference reuses the loop variable, callers.py:329-331);
                # it stays on the device and only the postcheck entries
                # are gathered
                pc = list(postcheck)
                vals = _gather_prod(rY['prod'], pc)
                for (ci, cj), v in zip(pc, vals):
                    if v == 0:
                        commonPos.add((ci, cj))

            for key in commonPos:
                donut = preDonuts[key]
                ll = preLL.get(key, donut)
                bpkey = (key[0] * res, key[1] * res)
                if (donut[2] > cfg.double_fold) and \
                        (ll[2] > cfg.double_fold) and \
                        ((donut[2] > cfg.single_fold) or
                         (ll[2] > cfg.single_fold)):
                    if bpkey not in pixel_table:
                        pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]
                    elif (donut[-1] < pixel_table[bpkey][7]) and \
                            (ll[-1] < pixel_table[bpkey][10]):
                        pixel_table[bpkey] = bpkey + (0,) + donut + ll[2:]
    return pixel_table


def hiccups_chrom(bands: ChromBands, cfg: HiccupsConfig, mesh=None,
                  scan_backend='auto', bh_backend='auto', check=False,
                  ir_backend='host', *, device=None):
    """Two-background multi-parameter caller (reference callers.py:44-362)
    on one ``device`` (default the card; JAX's parameters in its order,
    then the keyword ``device``).  Returns {(x_bp, y_bp): (cen_x, cen_y,
    radius, O, FoldK, pK, qK, FoldY, pY, qY)} in bp, the table of
    ``hicpeaks_tpu.core.engine.hiccups_chrom`` with the same
    ``scan_backend``, ``bh_backend`` and ``check`` (:func:`resolve_route`).

    ``check=True`` is the port's form of JAX's checkify: it raises
    FloatingPointError on a NaN in the sheets, in pass B's captures or in
    the scorer's E, O, ICE, Fold and p (and q), and IndexError on a
    compacted pixel outside the band.  checkify instrumented every float
    operation (NaN production, division by zero) and every gather; the
    port checks the named tensors at stage boundaries and the compacted
    indices, not each operation, and no division by zero that yields a
    finite result.

    On a CUDA device the bands must be float32 (the kernels take float32
    sheets and raise otherwise); on the CPU float64 bands compute what the
    JAX engine computes under x64.

    ``mesh`` (a ``parallel.mesh.TileMesh``; anything else is a TypeError)
    runs the chromosome on the mesh's column tiles, on ``mesh.devices``
    (``device`` is then not read), through the host gate as JAX's mesh
    route does.  JAX's mesh route sets no lambda-chunk edge suspect aside
    (``engine.py:757,1051``), which on the card moved a bench-shape q
    7.6e-6 off the float64 oracle; the port's tiles keep exact mode, so
    the mesh table is the single-device table.  ``ir_backend='device'``
    derives IR from the tiles (``parallel.tiles.ir_sharded``) instead of
    the host's; it has no effect without a mesh, as in JAX."""
    with span('hicpeaks.call'):
        check_mesh(mesh)
        if mesh is None:
            device = resolve_device(device)
        res = bands.res
        pw, ww = tuple(cfg.pw), tuple(cfg.ww)
        plan = tuple(poolplan.hiccups_pool_plan(pw, ww, cfg.maxww))
        p_list = tuple(sorted(set(pw)))
        total = bands.candidate_total(min(ww), cfg.maxapart // res)
        pairs = list(zip(pw, ww))
        max_count = getattr(bands, 'max_count', None)
        if max_count is None:
            max_count = float(bands.raw.max())
        route = resolve_route(scan_backend, bh_backend, check, total,
                              max_count, mesh)
        if mesh is None:
            results = _hiccups_scored(bands, cfg, plan, p_list, pairs,
                                      total, route, device)
        else:
            results = _mesh_hiccups_scored(bands, cfg, plan, p_list, pairs,
                                           total, route, mesh, ir_backend)

        with span('hicpeaks.merge'):
            pixel_table = _merge_pairs(results, pairs, cfg, res)
            Donuts = {(k[0] // res, k[1] // res): pixel_table[k][3:8]
                      for k in pixel_table}
            LL = {(k[0] // res, k[1] // res): pixel_table[k][8:]
                  for k in pixel_table}
        peak_list = local_clustering(Donuts, LL, res,
                                     min_count=cfg.min_marginal_peaks,
                                     r=2 * res, sumq=cfg.sumq,
                                     onlysummit=cfg.only_anchors)
        final_table = {}
        for pixel, cen, radius in peak_list:
            key = (pixel[0] * res, pixel[1] * res)
            final_table[key] = (cen[0] * res, cen[1] * res, radius * res) + \
                pixel_table[key][4:]
        return final_table


def bhfdr_chrom(bands: ChromBands, cfg: BHFDRConfig, mesh=None,
                scan_backend='auto', bh_backend='auto', check=False,
                ir_backend='host', *, device=None):
    """Donut-only caller with one global BH (reference callers.py:364-590)
    on one ``device`` (default the card).  Returns {(x_bp, y_bp): (cen_x,
    cen_y, radius, O, Fold, p, q)} in bp, the table of
    ``hicpeaks_tpu.core.engine.bhfdr_chrom``; the routes, the checks, the
    dtype rules, ``mesh`` and ``ir_backend`` are those of
    :func:`hiccups_chrom`.  On a mesh the global BH's fixed point sums
    each step's count over the tiles, and the float64 completion stays
    exact, as JAX calls its scorer without the mesh
    (``engine.py:1422-1425``): the mesh table equals the single-device
    one."""
    with span('hicpeaks.call'):
        check_mesh(mesh)
        if mesh is None:
            device = resolve_device(device)
        res = bands.res
        plan = tuple(poolplan.bhfdr_pool_plan(cfg.pw, cfg.ww, cfg.maxww))
        total = bands.candidate_total(cfg.ww, cfg.maxapart // res)
        route = resolve_route(scan_backend, bh_backend, check, total,
                              mesh=mesh)
        t_left = poolplan.left_threshold(total)

        def replay(c):
            return poolplan.emulate_freeze_bhfdr(plan, c, total)

        if mesh is None:
            sh, outs, decision = _scan_front(
                _staged_operands(bands, device), bands, plan, (cfg.pw,),
                _BHFDR_THR, cfg.ww, cfg.maxapart // res, cfg.ww, route,
                replay, lambda c: poolplan.device_allowed_bhfdr(
                    c, total, t_left, plan))
        else:
            ts, outs_t, decision = _mesh_front(
                bands, mesh, plan, (cfg.pw,), _BHFDR_THR, cfg.ww,
                cfg.maxapart // res, cfg.ww, route, replay, ir_backend)
        ctx = _exact_ctx(bands, plan, decision.allowed, _BHFDR_THR)
        exact = ctx and (ctx, cfg.pw, 'K')
        if mesh is not None and route.batched:
            r = _bhfdr_tiles(ts, outs_t, cfg.pw, int(cfg.ww), cfg.siglevel,
                             exact)
        else:
            if mesh is not None:
                sh, outs = _gathered(ts, outs_t, route)
            KS, KE, _, _ = outs[cfg.pw]
            r = _score_one(sh, KS, KE, int(cfg.ww), cfg.siglevel, route,
                           chunked=False, exact=exact)

        with span('hicpeaks.merge'):
            # insertion order is output order: Donuts follows the row-major
            # compaction, and the clustering and the bedpe writer iterate it
            Donuts = {(int(x), int(y)): (float(o), float(f), float(p),
                                         float(q))
                      for x, y, o, f, p, q in zip(r['x'], r['y'], r['O'],
                                                  r['Fold'], r['p'], r['q'])}
        pixel_list = local_clustering(Donuts, None, res,
                                      min_count=cfg.min_marginal_peaks,
                                      r=2 * res, onlysummit=cfg.only_anchors)
        with span('hicpeaks.merge'):
            pixel_table = {}
            for pixel, cen, radius in pixel_list:
                donut = Donuts[pixel]
                if donut[1] > 2:   # post-clustering fold gate,
                                   # callers.py:587
                    pixel_table[(pixel[0] * res, pixel[1] * res)] = \
                        (cen[0] * res, cen[1] * res, radius * res) + donut
        return pixel_table
