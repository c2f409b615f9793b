"""ctypes binding of ``jbig2dec.c``, built with the system C compiler into
``portbench/.build/`` (a fixed directory inside the checkout, so only a
checkout's first run compiles it)."""

import ctypes
import os
import shutil
import subprocess

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, 'jbig2dec.c')
BUILD_DIR = os.path.join(os.path.dirname(HERE), '.build')
LIB = os.path.join(BUILD_DIR, 'libpbjbig2.so')


def build():
    """The library's path, compiled first when missing or older than its
    source (written to a temporary name, then moved into place)."""
    if os.path.exists(LIB) and \
            os.path.getmtime(LIB) >= os.path.getmtime(SOURCE):
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    cc = next((c for c in ('cc', 'gcc', 'g++') if shutil.which(c)), None)
    if cc is None:
        raise RuntimeError('no C compiler for the JBIG2 decoder')
    tmp = '%s.%d.tmp' % (LIB, os.getpid())
    lang = ['-x', 'c'] if cc == 'g++' else []
    subprocess.check_call([cc, '-O2', '-shared', '-fPIC', '-o', tmp]
                          + lang + [SOURCE])
    os.replace(tmp, LIB)
    return LIB


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.pb_jbig2_decode.restype = ctypes.c_long
        lib.pb_jbig2_decode.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
        _lib = lib
    return _lib


def decode(stream, width, height):
    """uint8 (height, width) 0/1 JBIG2 pixels (1 = black) of an embedded
    segment stream; raises ValueError on a stream it cannot read."""
    out = np.zeros((height, width), np.uint8)
    n = _load().pb_jbig2_decode(stream, len(stream), out.ctypes.data,
                                width, height)
    if n <= 0:
        raise ValueError('JBIG2 stream not decoded (code %d)' % n)
    return out
