"""ctypes bridge to the port's native TXT parser (csrc/host/fastload.cpp).

Port of ``hicpeaks_tpu/io/fastload.py``.  The reference spends most of its
toCooler wall-clock in np.loadtxt (utilities.py:286; README.rst:287-291).
The native parser mmaps the file and scans it with one thread per slice.
It lives in the port's native host library, built at first use by
:func:`hicpeaks_tpu_torch.kernels.build.build_host`; a failed build
raises.  Where the parser itself declines a file (it returns -1 for one it
cannot open or map), numpy's ``loadtxt`` reads it, as in the JAX
package, and raises numpy's error.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = []


def _load_library():
    with _LOCK:
        if not _LIB:
            from ..kernels.build import build_host
            lib = ctypes.CDLL(build_host())
            lib.fastload_count.restype = ctypes.c_int64
            lib.fastload_count.argtypes = [ctypes.c_char_p]
            lib.fastload_parse.restype = ctypes.c_int64
            lib.fastload_parse.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
            ]
            _LIB.append(lib)
        return _LIB[0]


def load_txt(path):
    """-> (bin1 int64[], bin2 int64[], count float64[]) from a 3-column
    text file."""
    lib = _load_library()
    cap = lib.fastload_count(path.encode())
    if cap >= 0:
        b1 = np.empty(cap, np.int64)
        b2 = np.empty(cap, np.int64)
        ct = np.empty(cap, np.float64)
        n = lib.fastload_parse(
            path.encode(),
            b1.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            b2.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ct.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            cap)
        if n >= 0:
            return b1[:n], b2[:n], ct[:n]
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if data.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float64))
    return (data[:, 0].astype(np.int64), data[:, 1].astype(np.int64),
            data[:, 2].astype(np.float64))
