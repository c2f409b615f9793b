# Copied from archive_pdf_tools_tpu/codecs/jbig2.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: the .so goes to the port's build/.
"""JBIG2 mask codec: own native encoder with external-binary fallback.

The reference shells out to jbig2enc (``mrc.py:502-510``).  This module
prefers our in-tree C++ generic-region encoder (native/jbig2.cpp, built
on demand with g++ and loaded via ctypes); when a system ``jbig2``
binary exists it can be selected for byte-compatibility with jbig2enc.

``encode_jbig2(mask, embedded)`` -> bytes (embedded = PDF segment
stream, jbig2enc ``-p`` equivalent).  ``decode_jbig2`` round-trips our
own streams for verification.
"""

import ctypes
import os
import subprocess
import sys
from shutil import which

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'native')
_SO_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'build', 'libjbig2tpu.so')

_lib = None


_SOURCES = ('jbig2.cpp', 'crypto.cpp')


def _build_native():
    from ..utils.nativebuild import ensure_so
    srcs = [os.path.join(_NATIVE_DIR, f) for f in _SOURCES]
    ensure_so(_SO_PATH, srcs, [['-O3', '-fPIC', '-std=c++17']])


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    _build_native()
    lib = ctypes.CDLL(_SO_PATH)
    lib.jbig2tpu_encode.restype = ctypes.c_long
    lib.jbig2tpu_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.jbig2tpu_encode_symbol.restype = ctypes.c_long
    lib.jbig2tpu_encode_symbol.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.jbig2tpu_encode_band.restype = ctypes.c_long
    lib.jbig2tpu_encode_band.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.jbig2tpu_encode_packed.restype = ctypes.c_long
    lib.jbig2tpu_encode_packed.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.jbig2tpu_decode.restype = ctypes.c_long
    lib.jbig2tpu_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def encode_jbig2(mask, embedded=True, tpgdon=True, symbol_mode=False,
                 bands=1, symbol_corr_pct=90):
    """Encode a bool/uint8 (H, W) mask to JBIG2 bytes.

    symbol_mode: False -> generic region coding (the reference's plain
    ``jbig2 -p``, mrc.py:502-510); True -> symbol-dictionary + text-region
    coding (jbig2enc ``-s`` analogue, but lossless: only bit-identical
    connected components share a dictionary symbol); 'auto' -> whichever
    of the two encodes smaller; 'lossy' -> correlation-classified symbol
    coding (jbig2enc's default classifier behaviour: near-identical
    glyphs share one exemplar at ``symbol_corr_pct``/100 correlation,
    with a 2x2 all-mismatch veto against character substitution);
    'refine' -> lossy classes plus an XOR-composited residue region, so
    the decoded page is again bit-identical to the input (the in-spec
    equivalent of jbig2enc's never-finished refinement mode).

    bands > 1 (generic mode only) splits the page into that many
    horizontal bands coded as independent region segments on a thread
    pool — the arithmetic coder is serial per region, so banding is how
    the encode uses multiple host cores.  Any JBIG2 consumer handles the
    multi-segment stream (regions composite onto the page with OR)."""
    if bands > 1 and not symbol_mode:
        return _encode_jbig2_banded(mask, embedded, tpgdon, int(bands))
    lib = _get_lib()
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    h, w = m.shape
    cap = w * h // 4 + 1024
    while True:
        out = np.empty(cap, np.uint8)
        if symbol_mode:
            mode = {'auto': 2, 'refine': 3}.get(symbol_mode, 1)
            corr = int(symbol_corr_pct) \
                if symbol_mode in ('lossy', 'refine') else 0
            n = lib.jbig2tpu_encode_symbol(
                m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
                1 if tpgdon else 0, 1 if embedded else 0, mode, corr,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n == -1:     # degenerate (empty mask): generic fallback
                return encode_jbig2(m, embedded, tpgdon)
        else:
            n = lib.jbig2tpu_encode(
                m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
                1 if tpgdon else 0, 1 if embedded else 0,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap = -n


def encode_jbig2_packed(packed, w, h, invert=False, embedded=True,
                        tpgdon=True):
    """Encode a bit-packed (H, ceil(W/8)) uint8 mask (np.packbits row
    layout — the form the device mask transfer already uses) without
    ever materializing a byte-per-pixel array on the Python side.
    invert flips every pixel (the MRC pipeline stores ink as jbig2
    white, so it encodes the inverted mask).  Byte-identical with
    encode_jbig2(unpacked) — tested in tests/test_jbig2.py."""
    lib = _get_lib()
    m = np.ascontiguousarray(np.asarray(packed, np.uint8))
    stride = m.shape[1]
    cap = w * h // 4 + 1024
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jbig2tpu_encode_packed(
            m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), stride,
            w, h, 1 if invert else 0, 1 if tpgdon else 0,
            1 if embedded else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap = -n


def _segment_header(number, seg_type, page, data_len):
    import struct
    return struct.pack('>IBBBI', number, seg_type, 0x00, page, data_len)


def _page_info_segment(w, h):
    import struct
    return _segment_header(0, 48, 1, 19) + \
        struct.pack('>IIII', w, h, 0, 0) + b'\x01\x00\x00'


def _encode_jbig2_banded(mask, embedded, tpgdon, bands):
    """Split the mask into horizontal bands coded as independent
    immediate generic region segments on a thread pool (the ctypes call
    releases the GIL, so bands use multiple host cores).  Regions
    composite onto the page with the OR operator; bands are disjoint, so
    the decoded page is identical to single-region coding.  Compression
    cost: each band restarts the MQ coder and contexts (~tens of bytes
    per band)."""
    from concurrent.futures import ThreadPoolExecutor

    lib = _get_lib()
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    h, w = m.shape
    bands = max(1, min(int(bands), max(1, h // 128)))
    edges = [h * i // bands for i in range(bands + 1)]

    def encode_band(i):
        y0, y1 = edges[i], edges[i + 1]
        band = m[y0:y1]
        cap = w * (y1 - y0) // 4 + 1024
        while True:
            out = np.empty(cap, np.uint8)
            n = lib.jbig2tpu_encode_band(
                band.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                w, y1 - y0, y0, 1 if tpgdon else 0, i + 1,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
            if n >= 0:
                return out[:n].tobytes()
            cap = -n

    if bands == 1:
        segs = [encode_band(0)]
    else:
        with ThreadPoolExecutor(max_workers=bands) as pool:
            segs = list(pool.map(encode_band, range(bands)))

    parts = []
    if not embedded:
        parts.append(b'\x97\x4a\x42\x32\x0d\x0a\x1a\x0a\x01'
                     b'\x00\x00\x00\x01')   # file header, 1 page
    parts.append(_page_info_segment(w, h))
    parts.extend(segs)
    if not embedded:
        parts.append(_segment_header(bands + 1, 49, 1, 0))  # end of page
        parts.append(_segment_header(bands + 2, 51, 0, 0))  # end of file
    return b''.join(parts)


def decode_jbig2(data, w, h):
    """Decode an embedded stream produced by encode_jbig2 -> bool (H, W)."""
    lib = _get_lib()
    buf = np.frombuffer(bytes(data), np.uint8)
    out = np.empty(h * w, np.uint8)
    rc = lib.jbig2tpu_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h)
    if rc != 0:
        raise ValueError('jbig2 decode failed')
    return out.reshape(h, w).astype(bool)


def encode_jbig2_external(png_path, embedded=True, debug=False):
    """Invoke a system jbig2enc binary exactly like the reference
    (``mrc.py:502-510``); available when byte-parity with jbig2enc is
    required and the binary exists."""
    args = ['jbig2', '-p', png_path] if embedded else ['jbig2', png_path]
    if debug:
        print('check_output: %s' % args, file=sys.stderr)
    return subprocess.check_output(args)


def external_available():
    return which('jbig2') is not None
