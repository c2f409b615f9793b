"""Build the hand-written CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface (headers it shares with other sources, ``csrc/*.cuh``,
included by name) and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds, not minutes).  Builds go to ``build/`` beside the
package (git-ignored), are written to a unique temp file and published
with an atomic ``os.replace``, and are serialised by a per-path thread
lock plus an ``fcntl`` file lock, like ``archive_pdf_tools_tpu``'s
``utils/nativebuild.py``.

``-fmad=false`` keeps every float multiply and add separately rounded,
so the kernels reproduce the plain PyTorch versions bit for bit.

A variant of a source (``load(name, sigs, variant='x', defines=...)``)
is the same file built with ``-D`` defines into its own
``build/lib<name>.<variant>.so``; the default build keeps its flags and
its file name.

Nothing here falls back: a missing ``nvcc`` or a failed build raises.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-fmad=false', '-Xptxas', '-v', '-shared',
              '-Xcompiler', '-fPIC']

# name or name.variant -> {'seconds': build wall time (0.0 when already
# built), 'log': nvcc/ptxas output}; read by chip_smoke.py
BUILD_INFO = {}

_libs = {}
_guard = threading.Lock()
_path_locks = {}


def _nvcc():
    cand = [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                         'bin', 'nvcc'), shutil.which('nvcc')]
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found (set CUDA_HOME); the CUDA kernels '
                       'are built from csrc/ at first use')


def _stale(so_path, src):
    """Missing, or older than its source or a header of csrc/ (the
    sources include them by their plain names)."""
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith('.cuh')]
    return (not os.path.exists(so_path)
            or os.path.getmtime(so_path) < max(map(os.path.getmtime, deps)))


def _build(name, src, so_path, flags):
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _guard:
        lock = _path_locks.setdefault(so_path, threading.Lock())
    with lock, open(so_path + '.lock', 'w') as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if not _stale(so_path, src):      # built while we waited
                BUILD_INFO.setdefault(name, {'seconds': 0.0, 'log': ''})
                return
            tmp = '%s.tmp.%d' % (so_path, os.getpid())
            t0 = time.time()
            try:
                res = subprocess.run([_nvcc()] + flags + ['-o', tmp, src],
                                     capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError('nvcc failed for %s:\n%s%s'
                                       % (src, res.stdout, res.stderr))
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            BUILD_INFO[name] = {'seconds': time.time() - t0,
                                'log': res.stdout + res.stderr}
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def so_path(name, variant=None):
    """Where ``load`` puts the library of ``csrc/<name>.cu`` (of one
    variant of it)."""
    stem = name if variant is None else '%s.%s' % (name, variant)
    return os.path.join(BUILD_DIR, 'lib%s.so' % stem)


def load(name, signatures, variant=None, defines=None):
    """Build (if needed) and load ``csrc/<name>.cu``.

    signatures: {c_function: [ctypes argtypes]}; every function returns
    a C int (the ``cudaError_t`` of its launch).  variant: a name for a
    build with ``defines`` ({macro: value}), loaded from its own .so.
    Returns the CDLL."""
    if defines and variant is None:
        raise ValueError('cudabuild.load: defines need a variant name')
    key = name if variant is None else '%s.%s' % (name, variant)
    with _guard:
        if key in _libs:
            return _libs[key]
    src = os.path.join(CSRC, name + '.cu')
    path = so_path(name, variant)
    flags = NVCC_FLAGS + ['-D%s=%s' % kv for kv in sorted(
        (defines or {}).items())]
    if _stale(path, src):
        _build(key, src, path, flags)
    else:
        BUILD_INFO.setdefault(key, {'seconds': 0.0, 'log': ''})
    lib = ctypes.CDLL(path)
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    with _guard:
        _libs[key] = lib
    return lib


def check(err, what):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError('%s: CUDA launch failed with cudaError_t %d'
                           % (what, err))
