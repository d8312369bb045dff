"""ctypes bridge to the port's native host library (csrc/host/bandbuild.cpp).

Port of ``hicpeaks_tpu/ops/bandnative.py``.  One threaded C++ pass
replaces the numpy fancy-index copies + bincounts of
``ops/band.build_bands`` at genome scale, and a threaded per-pixel walk
replaces the numpy gathers of ``hostexact.ExactCtx.ring_sums`` (about
250x faster at 18K pixels).

The library is built at first use from the port's own source by
:func:`hicpeaks_tpu_torch.kernels.build.build_host`; a failed build
raises rather than leaving the caller on the slow numpy paths.  The
functions below still return None where the native routine declines its
input (pixels not sorted by bin1, a raw slab that is not C-contiguous
float32, maxw above 64), and the callers then take their numpy twins, as
the JAX package does.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = []

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)


def _register(lib):
    lib.band_build3.restype = ctypes.c_int64
    lib.band_build3.argtypes = [
        _i64p, _i64p, _f64p, ctypes.c_int64,    # bin1, bin2, count, n
        _f64p,                                  # weights
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # L, num, num_p
        ctypes.c_int64, ctypes.c_int64,         # Lp, ww_min
        ctypes.c_int64,                         # nb (csum blocks)
        _f32p, _f32p,                           # raw, staging
        _f64p, _i64p, _f64p,                    # csum_blk, nan, colsum
        _i64p, _f64p,                           # cand_hist, out_max
        _i64p, _i64p, _f64p, _f64p,             # dd, b1, cvals, ct (nullable)
    ]
    lib.ring_sums.restype = ctypes.c_int64
    lib.ring_sums.argtypes = [
        _f32p, ctypes.c_int64, ctypes.c_int64,  # raw, num_p, Lp
        _f64p, _f64p,                           # w64, ir64
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # L, ww_min, maxw
        _i64p, _i64p, ctypes.c_int64,           # d_idx, x_idx, n
        _f64p, _f64p, _f64p, _f64p, _f64p,      # Qm, Kc, Qc, Ke, Qe
    ]
    return lib


def _load_library():
    """The native host library, built on first use (thread-safe: the API's
    band-loader thread and the consumer's float64 completion both call
    in)."""
    with _LOCK:
        if not _LIB:
            from ..kernels.build import build_host
            _LIB.append(_register(ctypes.CDLL(build_host())))
        return _LIB[0]


def band_build_native(bin1, bin2, count, weights, L, num, num_p, Lp, ww_min,
                      keep_sparse=True):
    """-> (raw f32[num_p,Lp], csum_blk f64[num_p,nb], nan_counts
    i64[num_p], colsum f64[Lp], sparse (dd, b1, cvals, ct) or None,
    cand_hist i64[num_p], max_count float) or None when the input is not
    bin1-sorted (the canonical blocked csum requires it).  Semantics match
    the numpy path of ops/band.build_bands: ``csum_blk`` holds
    per-(diagonal, 128-column-block) balanced partial sums for
    band.fold_blocked_csum; ``keep_sparse=False`` skips the COO output
    copies (the engine derives everything it needs from ``cand_hist``/
    ``max_count``)."""
    lib = _load_library()
    bin1 = np.ascontiguousarray(bin1, np.int64)
    bin2 = np.ascontiguousarray(bin2, np.int64)
    count = np.ascontiguousarray(count, np.float64)
    weights = np.ascontiguousarray(weights, np.float64)
    n = bin1.size
    nb = (Lp + 127) // 128
    raw = np.zeros((num_p, Lp), np.float32)
    staging = np.zeros((Lp, num_p), np.float32)
    csum_blk = np.zeros((num_p, nb), np.float64)
    nan_counts = np.zeros(num_p, np.int64)
    colsum = np.zeros(Lp, np.float64)
    cand_hist = np.zeros(num_p, np.int64)
    out_max = np.zeros(1, np.float64)
    if keep_sparse:
        dd = np.empty(n, np.int64)
        b1 = np.empty(n, np.int64)
        cvals = np.empty(n, np.float64)
        ct = np.empty(n, np.float64)
        dd_p, b1_p = dd.ctypes.data_as(_i64p), b1.ctypes.data_as(_i64p)
        cv_p, ct_p = cvals.ctypes.data_as(_f64p), ct.ctypes.data_as(_f64p)
    else:
        dd_p = b1_p = ctypes.cast(None, _i64p)
        cv_p = ct_p = ctypes.cast(None, _f64p)
    m = lib.band_build3(
        bin1.ctypes.data_as(_i64p), bin2.ctypes.data_as(_i64p),
        count.ctypes.data_as(_f64p), n, weights.ctypes.data_as(_f64p),
        L, num, num_p, Lp, ww_min, nb,
        raw.ctypes.data_as(_f32p), staging.ctypes.data_as(_f32p),
        csum_blk.ctypes.data_as(_f64p), nan_counts.ctypes.data_as(_i64p),
        colsum.ctypes.data_as(_f64p), cand_hist.ctypes.data_as(_i64p),
        out_max.ctypes.data_as(_f64p), dd_p, b1_p, cv_p, ct_p)
    if m < 0:
        return None
    sparse = (dd[:m], b1[:m], cvals[:m], ct[:m]) if keep_sparse else None
    return (raw, csum_blk, nan_counts, colsum, sparse, cand_hist,
            float(out_max[0]))


def ring_sums_native(raw, w64, ir64, L, ww_min, maxw, d_idx, x_idx):
    """Threaded C++ per-pixel ring sums for the host-exact replay
    (hostexact.ExactCtx.ring_sums), or None when ``raw`` is not the dense
    C-contiguous float32 [num_p, Lp] slab or the vectors do not fit it.
    Returns dict of f64 [n, maxw+1] arrays keyed Qm/Kc/Qc/Ke/Qe.  Float64
    accumulation order differs from the numpy fallback's pairwise sums by
    O(cells*eps) — inside the engine's 1e-8 stat parity bounds."""
    if raw.dtype != np.float32 or not raw.flags.c_contiguous:
        return None
    d_idx = np.ascontiguousarray(d_idx, np.int64)
    x_idx = np.ascontiguousarray(x_idx, np.int64)
    w64 = np.ascontiguousarray(w64, np.float64)
    ir64 = np.ascontiguousarray(ir64, np.float64)
    n = d_idx.size
    num_p, Lp = raw.shape
    if w64.size != Lp or ir64.size != num_p:
        return None
    lib = _load_library()
    out = {k: np.zeros((n, maxw + 1)) for k in ('Qm', 'Kc', 'Qc', 'Ke', 'Qe')}
    rc = lib.ring_sums(
        raw.ctypes.data_as(_f32p), num_p, Lp,
        w64.ctypes.data_as(_f64p), ir64.ctypes.data_as(_f64p),
        L, ww_min, maxw,
        d_idx.ctypes.data_as(_i64p), x_idx.ctypes.data_as(_i64p), n,
        out['Qm'].ctypes.data_as(_f64p), out['Kc'].ctypes.data_as(_f64p),
        out['Qc'].ctypes.data_as(_f64p), out['Ke'].ctypes.data_as(_f64p),
        out['Qe'].ctypes.data_as(_f64p))
    if rc != 0:     # maxw outside 0..64: the numpy walk serves it
        return None
    return out
