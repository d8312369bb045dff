"""Build and load the package's CUDA kernels and its native host library.

The CUDA sources under ``hicpeaks_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``), one ``nvcc`` per source, all started together,
and linked into ONE shared library with a plain C interface, loaded with
``ctypes``.  The build happens at first use, from the
repository's sources only, into ``build/kernels/`` at the repository root;
the library's file name carries a hash of the sources and flags, so an
edit rebuilds it.  A failed build raises: nothing falls back to the plain
PyTorch twins.

Floating-point contraction is off (``--fmad=false``) because the pass-B
kernel replays the ring scan's add chains bit for bit.

The host library (``csrc/host/*.cpp``: ``bandbuild.cpp``, the band
scatter and the float64 ring sums, and ``fastload.cpp``, the threaded TXT
parser) is compiled by the host C++ compiler into one library in
``build/host/`` at first use, with the flags the JAX package's native
Makefile uses.  They fix the float contraction of the float64 band and
ring sums, which must equal the JAX package's bit for bit.  A failed build
raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'kernels')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '--fmad=false', '-std=c++17', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v')

HOST_SRCS = tuple(sorted(glob.glob(os.path.join(CSRC_DIR, 'host',
                                                '*.cpp'))))
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), 'build', 'host')
CXX_FLAGS = ('-O3', '-march=native', '-std=c++17', '-fPIC', '-pthread')

_vp = ctypes.c_void_p
_i32 = ctypes.c_int
_i64 = ctypes.c_longlong
_f32 = ctypes.c_float

#: C entry points: name -> argtypes (each returns the cudaError_t of its
#: launch as an int).
SIGNATURES = {
    # raw, cand, num_p, Lp, meta, n_meta, n_e, maxw, thr, counts, stream
    'hp_scan_pass_a': [_vp, _vp, _i32, _i32, _vp, _i32, _i32, _i32, _f32,
                       _vp, _vp],
    # raw, cband, eband, cand, allowed, num_p, Lp, meta, n_meta, n_e, n_p,
    # maxw, thr, out, stream
    'hp_scan_pass_b': [_vp, _vp, _vp, _vp, _vp, _i32, _i32, _vp, _i32, _i32,
                       _i32, _i32, _f32, _vp, _vp],
    # oc, cid, n, B, S, C, hist, blocks, stream
    'hp_chunk_hist': [_vp, _vp, _i64, _i32, _i32, _i32, _vp, _i32, _vp],
}


class KernelLibrary:
    """The loaded shared library plus what its build printed."""

    def __init__(self, path, build_log, build_s):
        self.path = path
        self.build_log = build_log
        self.build_s = build_s
        self.lib = ctypes.CDLL(path)
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int


def _sources(csrc_dir=CSRC_DIR):
    return sorted(glob.glob(os.path.join(csrc_dir, '*.cu'))
                  + glob.glob(os.path.join(csrc_dir, '*.cuh')))


def _nvcc():
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA '
                       'kernels of hicpeaks_tpu_torch cannot be built')


def _hashed_path(build_dir, stem, flags, sources):
    """Build-output path named by a hash of the flags and the sources."""
    h = hashlib.sha256(' '.join(flags).encode())
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, 'rb') as f:
            h.update(f.read())
    return os.path.join(build_dir, f'{stem}_{h.hexdigest()[:16]}.so')


def library_path(csrc_dir=CSRC_DIR, build_dir=BUILD_DIR):
    """Build-output path for the sources of ``csrc_dir`` and the flags."""
    return _hashed_path(build_dir, 'libhicpeaks_kernels', NVCC_FLAGS,
                        _sources(csrc_dir))


def build(csrc_dir=CSRC_DIR, build_dir=BUILD_DIR):
    """Compile the kernels of ``csrc_dir`` (default the package's) into
    ``build_dir`` if the hashed library is missing; returns (path, compiler
    output, seconds spent)."""
    path = library_path(csrc_dir, build_dir)
    if os.path.exists(path):
        return path, '', 0.0
    os.makedirs(build_dir, exist_ok=True)
    tmp = f'{path}.tmp.{os.getpid()}'
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources(csrc_dir) if s.endswith('.cu')):
        obj = f'{tmp}.{os.path.basename(src)}.o'
        cmd = [nvcc, *NVCC_FLAGS, '-c', src, '-o', obj]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    # every compiler ends before anything is raised
    outputs = [proc.communicate()[0] for _, _, proc in jobs]
    objs = [obj for _, obj, _ in jobs]
    try:
        for (cmd, _, proc), out in zip(jobs, outputs):
            if proc.returncode != 0:
                raise RuntimeError(f'nvcc failed (rc {proc.returncode}):\n'
                                   f'{" ".join(cmd)}\n{out}')
        cmd = [nvcc, '-shared', '-o', tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc link failed (rc {proc.returncode}):\n'
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    dt = time.perf_counter() - t0
    os.replace(tmp, path)
    return path, ''.join(outputs) + proc.stdout + proc.stderr, dt


def build_host():
    """Compile the native host library if its hashed file is missing;
    returns its path.  Raises if the compiler is missing or fails."""
    path = _hashed_path(HOST_BUILD_DIR, 'libhicpeaks_host', CXX_FLAGS,
                        HOST_SRCS)
    if os.path.exists(path):
        return path
    cxx = shutil.which('g++')
    if cxx is None:
        raise RuntimeError('g++ not found on PATH: the native host library '
                           'of hicpeaks_tpu_torch cannot be built')
    os.makedirs(HOST_BUILD_DIR, exist_ok=True)
    tmp = f'{path}.tmp.{os.getpid()}'
    cmd = [cxx, *CXX_FLAGS, '-shared', '-o', tmp, *HOST_SRCS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'host library build failed (rc {proc.returncode})'
                           f':\n{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)
    return path


_LOCK = threading.Lock()
_LOADED = []


def load() -> KernelLibrary:
    """The kernel library, built on first use (thread-safe)."""
    with _LOCK:
        if not _LOADED:
            _LOADED.append(KernelLibrary(*build()))
        return _LOADED[0]


def check(err, what):
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with error {err}')
