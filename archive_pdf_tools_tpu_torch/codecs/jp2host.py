"""Host side of the in-tree JPEG2000 encoder (``-J tpu``), jax-free.

The JAX package's ``codecs/jp2tpu.py`` runs ``import jax`` at module
level (``:257``), so the port cannot import it.  This module is a
verbatim copy of its jax-free parts, in the source's order:

- ``T1_STATS`` and ``_stat`` (``:36-50``), the CDF 9/7 constants and
  ``ICT_FIX`` (``:53-72``), ``_get_lib`` (``:75-120``; the shared
  ``native/jp2t1.cpp`` built by the jax-free ``utils/nativebuild``),
  ``_band_shapes`` (``:123-136``);
- ``_band_norm``, ``_step_to_eps_mu`` and ``band_layout``
  (``:217-254``), ``_native_transform`` (``:311-345``);
- Tier-1 block coding, PCRD rate allocation, Tier-2 and box writers from
  ``_ORIENT_CODE`` to ``_jp2_wrap`` (``:380-1107``) and ``_host_encode``
  (``:1140-1237``);
- ``_PACK4_K_FINE`` and ``_pack4_sets`` (``:1393-1403``), the numpy
  pack twins ``_packK_shifts_np`` / ``_packK_apply_np``
  (``:1549-1578``) and ``_pack8_shifts_np`` / ``_pack8_apply_np``
  (``:1603-1633``), ``_AsyncMeta`` (``:1658-1676``) and
  ``encode_jp2_from_qbands`` (``:1924-1940``).

The only edits: the library is built into the port's ``build/``
(``_SO_PATH``), by the port's copy of ``utils/nativebuild``.
The device side (the transform, the pack requantisation on the device
and the batch API) is the port's ``codecs/jp2tpu.py``.
"""

import ctypes
import math
import os
import struct
import threading

from concurrent.futures import ThreadPoolExecutor

import numpy as np

# APT_T1_STATS=1: accumulate per-encode Tier-1 work counters (initial/
# rescue/final phase wall time, block and byte counts) in T1_STATS for
# perf attribution — the rescue rounds are the content-dependent part
# of the encode cost and invisible to stage-level timing.
T1_STATS = {}
_T1_STATS_LOCK = threading.Lock()


def _stat(key, dt=0.0, n=0):
    # Pages encode concurrently on the pipeline's thread pool; the
    # read-modify-write must be atomic or counter updates are lost.
    if os.environ.get('APT_T1_STATS'):
        with _T1_STATS_LOCK:
            t, c = T1_STATS.get(key, (0.0, 0))
            T1_STATS[key] = (t + dt, c + n)


# --- CDF 9/7 lifting constants (ITU-T T.800 Annex F) ---
ALPHA = -1.586134342059924
BETA = -0.052980118572961
GAMMA = 0.882911075530934
DELTA = 0.443506852043971
K = 1.230174104914001

CB = 64            # code-block side

# ICT (T.800 irreversible colour transform) coefficients in 2^-16 fixed
# point — shared verbatim by the device transform and native/jp2t1.cpp
# so both compute the identical exact-integer ICT (see _device_transform).
ICT_FIX = [[round(c * 65536) for c in row] for row in
           [[0.299, 0.587, 0.114],
            [-0.16875, -0.33126, 0.5],
            [0.5, -0.41869, -0.08131]]]
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'native')
_SO_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'build', 'libjp2t1.so')
_lib = None


def _get_lib():
    global _lib
    if _lib is not None:
        return _lib
    src = os.path.join(_NATIVE_DIR, 'jp2t1.cpp')
    # -ffp-contract=off: only the explicit fmaf calls in Lift1D may
    # fuse, so the DWT numerics exactly mirror the jitted XLA-CPU
    # path; -mfma makes those fmaf calls single instructions
    # (fallback build without it still computes the same values via
    # libm fmaf, just slower).
    from ..utils.nativebuild import ensure_so
    flags = ['-O3', '-fPIC', '-std=c++17', '-ffp-contract=off']
    ensure_so(_SO_PATH, [src], [flags + ['-mfma'], flags])
    lib = ctypes.CDLL(_SO_PATH)
    lib.jp2t1_encode_block.restype = ctypes.c_long
    lib.jp2t1_encode_block.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double)]
    lib.jp2t1_encode_band.restype = ctypes.c_long
    lib.jp2t1_encode_band.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.jp2dwt_quantize.restype = ctypes.c_long
    lib.jp2dwt_quantize.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32)]
    lib.jp2t2_packet_header.restype = ctypes.c_long
    lib.jp2t2_packet_header.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long]
    _lib = lib
    return lib


def _band_shapes(w, h, levels):
    """Per-band (bh, bw) in codestream order, matching the lifting
    sizes (low = ceil(n/2))."""
    lws, lhs = [w], [h]
    for _ in range(levels):
        lws.append((lws[-1] + 1) // 2)
        lhs.append((lhs[-1] + 1) // 2)
    shapes = [(lhs[levels], lws[levels])]
    for r in range(levels):
        lvl = levels - r
        pw, ph = lws[lvl - 1], lhs[lvl - 1]
        lw, lh = lws[lvl], lhs[lvl]
        shapes += [(lh, pw - lw), (ph - lh, lw), (ph - lh, pw - lw)]
    return shapes


# --- quantization -------------------------------------------------------

def _band_norm(level, orient):
    """Approximate L2 norm of the synthesis basis (distortion weight);
    doubles per decomposition level."""
    base = {'LL': 1.0, 'LH': 0.56, 'HL': 0.56, 'HH': 0.31}[orient]
    return base * (2.0 ** level)


def _step_to_eps_mu(step, gain):
    """Quantizer step -> (eps, mu) per T.800 E.1.1 with R_b = 8 + gain
    (8-bit input): step = 2^(R_b - eps) * (1 + mu / 2^11)."""
    rb = 8 + gain
    e = rb - math.floor(math.log2(step))
    m = step / (2.0 ** (rb - e)) - 1.0
    mu = int(round(m * 2048))
    if mu > 2047:
        mu = 0
        e -= 1
    eps = max(0, min(31, e))
    return eps, mu


def band_layout(levels, base_delta):
    """Static per-subband metadata in codestream order (LL first, then
    per resolution HL, LH, HH): (orient, level, gain, eps, mu, step)."""
    out = [None] * (3 * levels + 1)
    def meta(level, orient, gain):
        delta = base_delta / _band_norm(level, orient)
        eps, mu = _step_to_eps_mu(delta, gain)
        # actual step implied by (eps, mu) so encoder/decoder agree
        step = (2.0 ** (8 + gain - eps)) * (1.0 + mu / 2048.0)
        return (orient, level, gain, eps, mu, step)
    out[0] = meta(levels, 'LL', 0)
    for r in range(levels):                  # coarsest first
        level = levels - r
        out[1 + 3 * r] = meta(level, 'HL', 1)
        out[2 + 3 * r] = meta(level, 'LH', 1)
        out[3 + 3 * r] = meta(level, 'HH', 2)
    return out


def _native_transform(arr, levels, rgb, base_delta):
    """Pure-host DWT + quantize (native/jp2t1.cpp): for machines where
    shipping coefficients back from an accelerator costs more than
    computing them on the host."""
    arr = np.asarray(arr, np.uint8)
    if arr.ndim == 3 + (1 if rgb else 0):          # batched: per page,
        pages = [_native_transform(a, levels, rgb, base_delta)
                 for a in arr]                     # stacked like the jit
        return tuple(
            tuple(np.stack([pg[c][k] for pg in pages])
                  for k in range(len(pages[0][c])))
            for c in range(len(pages[0])))
    lib = _get_lib()
    h, w = arr.shape[:2]
    ncomp = 3 if rgb else 1
    layout = band_layout(levels, float(base_delta))
    steps = np.array([m[5] for m in layout], np.float64)
    shapes = _band_shapes(w, h, levels)
    total = sum(a * b for (a, b) in shapes)
    out = np.empty(total * ncomp, np.int32)
    img = np.ascontiguousarray(arr)
    lib.jp2dwt_quantize(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
        ncomp, levels,
        steps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    comps = []
    pos = 0
    for _c in range(ncomp):
        bands = []
        for (bh, bw) in shapes:
            bands.append(out[pos:pos + bh * bw].reshape(bh, bw))
            pos += bh * bw
        comps.append(tuple(bands))
    return tuple(comps)


_ORIENT_CODE = {'LL': 0, 'LH': 0, 'HL': 1, 'HH': 2}


def _encode_block(lib, blk, orient_code, max_passes=-1, max_bytes=0):
    h, w = blk.shape
    cap = max(4096, w * h * 4)
    out = np.empty(cap, np.uint8)
    nbps = ctypes.c_int()
    npasses = ctypes.c_int()
    rates = np.zeros(128, np.int64)
    dists = np.zeros(128, np.float64)
    blk = np.ascontiguousarray(blk, np.int32)
    n = lib.jp2t1_encode_block(
        blk.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), w, h,
        orient_code, max_passes, max_bytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
        ctypes.byref(nbps), ctypes.byref(npasses),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if n < 0:
        raise RuntimeError('jp2t1 buffer overflow')
    np_ = npasses.value
    return (out[:n].tobytes(), nbps.value, np_,
            rates[:np_].copy(), dists[:np_].copy())


class _CodeBlock:
    __slots__ = ('data', 'nbps', 'npasses', 'rates', 'dists', 'arr',
                 'orient_code', 'weight', 'chosen', 'chosen_bytes',
                 'capped', 'pass_capped', 'hull_rows')

    def __init__(self, arr, orient_code, weight):
        self.arr = arr
        self.orient_code = orient_code
        self.weight = weight
        self.chosen = 0
        self.chosen_bytes = b''
        # capped: a BYTE cap cut this block's passes mid-plane — the
        # hull near the cut is unreliable, so rescue uses a slack.
        # pass_capped: a PASS-count cap stopped it at an exact pass
        # boundary — the recorded hull is exact below the cap, so
        # rescue triggers only when the pick reaches the cap itself.
        self.capped = False
        self.pass_capped = False
        self.hull_rows = None


def _hull_rows(cb):
    """Per-block PCRD candidate rows, cached on the block (rescue
    rounds re-run the threshold search over thousands of unchanged
    blocks — only re-encoded blocks rebuild their hull).

    Returns (seg_slopes, pt_rates, pt_picks) lists: the convex hull of
    (rate, weighted distortion) truncation points, as decreasing
    segment slopes plus the realized byte cost / pass pick per hull
    point (truncated picks cost the truncation margin too)."""
    if cb.hull_rows is not None:
        return cb.hull_rows
    pts = [(0, 0.0)]
    for i in range(cb.npasses):
        pts.append((int(cb.rates[i]), cb.dists[i] * cb.weight))
    hull = [0]
    for i in range(1, len(pts)):
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            s1 = (pts[b][1] - pts[a][1]) / max(1, pts[b][0] - pts[a][0])
            s2 = (pts[i][1] - pts[b][1]) / max(1, pts[i][0] - pts[b][0])
            if s2 >= s1:
                hull.pop()
            else:
                break
        hull.append(i)
    slopes, rates_, picks = [], [0], [0]
    for j in range(1, len(hull)):
        a, b = hull[j - 1], hull[j]
        slopes.append((pts[b][1] - pts[a][1]) /
                      max(1, pts[b][0] - pts[a][0]))
        rates_.append(pts[b][0] +
                      (_TRUNC_MARGIN if hull[j] < cb.npasses else 0))
        picks.append(hull[j])
    cb.hull_rows = (slopes, rates_, picks)
    return cb.hull_rows


def _pcrd_choose(blocks, target_bytes):
    """PCRD core: one global slope threshold over every block's
    convex-hull segments; sets cb.chosen per block.

    Exact closed form: per block the hull slopes are strictly
    decreasing, so a threshold L includes precisely a per-block prefix
    of segments.  Flattening all segments, sorting by slope once and
    scanning slope-class boundaries yields the largest-inclusion
    feasible threshold directly — replacing the former 48-iteration
    vectorized bisection (~33 ms per encode at realistic block counts;
    measured 2026-08-20) with one argsort.  Equal slopes stay an
    all-or-nothing class, matching the threshold semantics the
    bisection converged to."""
    rows_data = [_hull_rows(cb) for cb in blocks]
    for cb in blocks:
        cb.chosen = 0
    nseg = [len(r[0]) for r in rows_data]
    total_seg = sum(nseg)
    if total_seg == 0 or target_bytes <= 0:
        return
    slopes = np.empty(total_seg, np.float64)
    deltas = np.empty(total_seg, np.int64)    # realized bytes/segment
    picks = np.empty(total_seg, np.int32)
    owner = np.empty(total_seg, np.int32)
    pos = 0
    for bi, (s, r, p) in enumerate(rows_data):
        n = nseg[bi]
        if not n:
            continue
        slopes[pos:pos + n] = s
        rr = np.asarray(r, np.int64)
        deltas[pos:pos + n] = rr[1:] - rr[:-1]
        picks[pos:pos + n] = np.asarray(p)[1:]
        owner[pos:pos + n] = bi
        pos += n
    # the bisection never tested thresholds at/below 1e-9: segments
    # that flat never get included (they carry ~no distortion anyway)
    live = np.flatnonzero(slopes >= 1e-9)
    if live.size == 0:
        return
    order = live[np.argsort(-slopes[live], kind='stable')]
    ls = slopes[order]
    csum = np.cumsum(deltas[order])
    # slope-class ends (inclusion cannot split an equal-slope class)
    ends = np.flatnonzero(np.diff(ls) < 0)
    ends = np.append(ends, ls.size - 1)
    feas = ends[csum[ends] <= target_bytes]
    if feas.size == 0:
        return
    k = int(feas[-1]) + 1
    # per block keep the deepest included segment's pass pick (picks
    # increase along each block's hull, so max == last)
    chosen = np.zeros(len(blocks), np.int64)
    np.maximum.at(chosen, owner[order[:k]], picks[order[:k]])
    for bi in np.flatnonzero(chosen):
        blocks[bi].chosen = int(chosen[bi])


def _allocate_rate(blocks, target_bytes, lib, workers, bands=None):
    """PCRD with starved-block recovery: blocks are T1-coded under a
    work cap (_t1_all), so when the threshold search wants EVERY
    recorded pass of a cap-cut block, its true optimum may lie beyond
    the cap — re-encode just those uncapped and re-run the search.
    Converges to the uncapped allocation while coding a fraction of
    the passes (at ratio 750 the cap floor saves ~10x the pass work).

    bands: the _Band list owning `blocks`; when given, rescue
    re-encodes ride the band-batched native entry (skip-capped) instead
    of per-block ctypes calls."""
    slack = int(os.environ.get('APT_T1_STARVE_SLACK', '3'))
    max_rounds = int(os.environ.get('APT_T1_MAX_RESCUE_ROUNDS', '3'))
    kcap = max(48, len(blocks) // 32)

    def tail_slope(cb):
        if cb.npasses < 2:
            return float('inf')
        return (cb.dists[-1] - cb.dists[-2]) * cb.weight / \
            max(1, int(cb.rates[-1]) - int(cb.rates[-2]))

    for _round in range(max_rounds + 1):
        _pcrd_choose(blocks, target_bytes)
        # byte-capped blocks rescue within `slack` passes of the cut
        # (the hull near a mid-plane cut is unreliable); pass-capped
        # blocks have an exact hull below the cap, so only a pick AT
        # the cap means the optimum may lie beyond it
        starved = [cb for cb in blocks
                   if (cb.capped and cb.chosen >= cb.npasses - slack)
                   or (cb.pass_capped and cb.chosen >= cb.npasses)]
        if not starved or _round == max_rounds:
            break
        if len(starved) > kcap:
            # noise-like content: nearly every block sits at the cap
            # and blocks are fungible (the threshold barely moves if a
            # few stay truncated) — rescue only the highest-slope ones
            # so re-encode work stays bounded
            starved.sort(key=tail_slope, reverse=True)
            starved = starved[:kcap]
        import time as _t
        _r0 = _t.time()
        if bands is not None:
            band_of = {id(cb): band for band in bands
                       for cb in band.blocks}
            by_band = {}
            for cb in starved:
                band = band_of[id(cb)]
                by_band.setdefault(id(band), (band, set()))[1].add(id(cb))
            for band, ids in by_band.values():
                _encode_band_blocks(lib, band, only=ids)
        else:
            _encode_blocks(starved, lib, workers, caps=None)
        _stat('rescue', _t.time() - _r0, len(starved))
    _final_encode(blocks, lib, workers)


# Safety margin added to a pass-end rate when truncating the MQ stream
# there: the decoder's register holds up to two bytes of lookahead
# beyond the encoder's emitted count, and it feeds 0xFF past the end of
# a truncated stream (T.800 J.10.2 behaviour all conformant decoders
# implement).  rates[] already includes the pending byte + 1; +2 covers
# the lookahead.  Validated empirically against full decodes in
# tests/test_jp2tpu.py::test_truncation_matches_reencode.
_TRUNC_MARGIN = 2


def _final_encode(blocks, lib, workers):
    """Realize each block's chosen pass count by TRUNCATING its fully
    coded stream at the recorded pass-end rate (+margin) — no
    re-encode.  Round 1 re-encoded every truncated block (25% of the
    clean-page encode time); truncation is what OpenJPEG/Kakadu ship
    and is decodable by construction: the included passes' decisions
    use only bytes before the cut."""
    for cb in blocks:
        if cb.chosen <= 0:
            cb.chosen_bytes = b''
            cb.chosen = 0
        elif cb.chosen >= cb.npasses:
            cb.chosen = cb.npasses
            cb.chosen_bytes = cb.data
        else:
            cut = min(len(cb.data),
                      int(cb.rates[cb.chosen - 1]) + _TRUNC_MARGIN)
            cb.chosen_bytes = cb.data[:cut]


# --- Tier-2: tag trees and packet headers ------------------------------

class _BitWriter:
    """Packet-header bit writer with 0xFF bit-stuffing: a byte following
    an 0xFF carries only 7 bits (MSB forced 0).  The per-byte capacity
    is fixed when the byte starts, not re-evaluated per bit."""

    def __init__(self):
        self.bytes = bytearray()
        self.bits = 0
        self.nbits = 0
        self.limit = 8

    def put(self, bit):
        if self.nbits == 0:
            self.limit = 7 if (self.bytes and self.bytes[-1] == 0xFF) \
                else 8
        self.bits = (self.bits << 1) | (bit & 1)
        self.nbits += 1
        if self.nbits == self.limit:
            self.bytes.append(self.bits)
            self.bits = 0
            self.nbits = 0

    def put_bits(self, val, n):
        for i in range(n - 1, -1, -1):
            self.put((val >> i) & 1)

    def flush(self):
        if self.nbits:
            self.bytes.append(self.bits << (self.limit - self.nbits))
            self.bits = 0
            self.nbits = 0
        if self.bytes and self.bytes[-1] == 0xFF:   # can't end on FF
            self.bytes.append(0)
        return bytes(self.bytes)


class _TagTree:
    """Tag tree (T.800 B.10.2), encoder side.  Per node: the value
    (min over its leaves), a broadcast lower bound ``low`` and a
    ``known`` flag; threshold coding emits 0 for "value above current
    bound", 1 when the node's value is reached."""

    def __init__(self, w, h):
        self.levels = [(w, h)]
        while w > 1 or h > 1:
            w = (w + 1) // 2
            h = (h + 1) // 2
            self.levels.append((w, h))
        self.value = [np.zeros((lh, lw), np.int32)
                      for (lw, lh) in self.levels]
        self.low = [np.zeros((lh, lw), np.int32)
                    for (lw, lh) in self.levels]
        self.known = [np.zeros((lh, lw), bool)
                      for (lw, lh) in self.levels]

    def set(self, x, y, v):
        self.value[0][y, x] = v

    def finalize(self):
        for li in range(1, len(self.levels)):
            prev = self.value[li - 1]
            lw, lh = self.levels[li]
            # min-pool 2x2 (ragged edges padded with the +inf sentinel)
            pad = np.full((lh * 2, lw * 2), 2 ** 30, np.int32)
            pad[:prev.shape[0], :prev.shape[1]] = prev
            self.value[li] = np.minimum(
                np.minimum(pad[0::2, 0::2], pad[0::2, 1::2]),
                np.minimum(pad[1::2, 0::2], pad[1::2, 1::2]))

    def encode(self, bw, x, y, threshold):
        path = []
        lx, ly = x, y
        for li in range(len(self.levels)):
            path.append((li, lx, ly))
            lx //= 2
            ly //= 2
        low = 0
        for (li, lx, ly) in reversed(path):      # root first
            if low > self.low[li][ly, lx]:
                self.low[li][ly, lx] = low
            else:
                low = self.low[li][ly, lx]
            while low < threshold:
                if low >= self.value[li][ly, lx]:
                    if not self.known[li][ly, lx]:
                        bw.put(1)
                        self.known[li][ly, lx] = True
                    break
                bw.put(0)
                low += 1
            self.low[li][ly, lx] = low


# --- packet / codestream assembly --------------------------------------

def _npasses_code(bw, n):
    """Number-of-coding-passes codeword (T.800 B.10.6)."""
    if n == 1:
        bw.put(0)
    elif n == 2:
        bw.put(1)
        bw.put(0)
    elif n <= 5:
        bw.put_bits(0b11, 2)
        bw.put_bits(n - 3, 2)
    elif n <= 36:
        bw.put_bits(0b1111, 4)
        bw.put_bits(n - 6, 5)
    else:
        bw.put_bits(0b111111111, 9)
        bw.put_bits(n - 37, 7)


class _Band:
    """One subband of one component: quantized array + code blocks.

    plane_budget: planes the transfer shipped for this band (pack4),
    None for full-precision bands.  Plane-budgeted blocks have at most
    3K-2 passes, so the T1 byte cap saves nothing on them and its
    starved-block rescue would fire on every ordinary fully-coded
    block (measured: a 1287-block rescue storm on one 8-page batch) —
    _t1_all skips caps for them."""

    plane_budget = None

    def __init__(self, orient, level, gain, eps, mu, step, arr):
        self.orient = orient
        self.level = level
        self.gain = gain
        self.eps = eps
        self.mu = mu
        self.step = step
        self.arr = arr
        h, w = arr.shape
        self.nx = -(-w // CB) if w else 0
        self.ny = -(-h // CB) if h else 0
        self.blocks = []          # raster order
        weight = (step * _band_norm(level, orient)) ** 2
        for by in range(self.ny):
            for bx in range(self.nx):
                # store the VIEW; _encode_block makes the contiguous
                # int32 copy only for blocks that actually encode (on
                # pack4 fg layers most fine-band blocks are all-zero)
                blk = arr[by * CB:(by + 1) * CB, bx * CB:(bx + 1) * CB]
                self.blocks.append(_CodeBlock(
                    blk, _ORIENT_CODE[orient], weight))


def _encode_blocks(blocks, lib, workers, caps=None, max_passes=-1):
    """T1-encode blocks (optionally byte- or pass-capped), recording
    whether a cap actually cut passes so the allocator can re-encode
    starved blocks uncapped."""
    def run(cb):
        if not cb.arr.any():
            # all-zero block: no planes, no passes, no bytes — skip the
            # int32 copy and the native call (the common case for fine
            # bands of pack4 MRC layers)
            cb.data, cb.nbps, cb.npasses = b'', 0, 0
            cb.rates = np.zeros(0, np.int64)
            cb.dists = np.zeros(0, np.float64)
            cb.capped = False
            cb.pass_capped = False
            cb.hull_rows = None
            return
        cap = caps.get(id(cb), 0) if caps else 0
        (cb.data, cb.nbps, cb.npasses, cb.rates, cb.dists) = \
            _encode_block(lib, cb.arr, cb.orient_code,
                          max_passes=max_passes if max_passes > 0 else -1,
                          max_bytes=cap)
        short = cb.npasses < 3 * cb.nbps - 2
        cb.capped = bool(cap) and short
        cb.pass_capped = (not cb.capped and max_passes > 0
                          and cb.npasses >= max_passes and short)
        cb.hull_rows = None

    if workers > 1 and len(blocks) > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(run, blocks))
    else:
        for cb in blocks:
            run(cb)


def _encode_band_blocks(lib, band, caps=None, only=None, max_passes=-1):
    """T1-encode every block of one band with ONE native call.

    only: optional set of block ids — the native call skips every
    other block (caps entry -1) and their recorded state is left
    untouched; used by the starved-block rescue so re-encodes stay on
    this batched entry instead of the per-block ctypes path (which
    cost ~1 ms/block of marshalling + GIL churn, measured 2026-08-20).

    max_passes: pass-count work cap applied to every block of the
    band (<= 0 = all passes); blocks it actually cuts are flagged
    capped so the rate allocator's starved rescue covers them.

    The per-block path costs, per block, an ascontiguousarray + a
    ctypes call + a GIL release/reacquire; inside recode() the GIL
    ping-pong against the loader/qband-fetch threads inflated Tier-1
    from a measured 0.10 ms/block (quiet process, tools/t1_profile.py)
    to 0.42 ms/block (e2e A/B 'initial' stat).  Batching the band into
    native/jp2t1.cpp:jp2t1_encode_band holds the GIL handoff count at
    one per band and moves the all-zero-block test into the same C++
    scan that extracts the block.  Streams are byte-identical with the
    per-block path (tests/test_jp2tpu.py)."""
    blocks = band.blocks
    nb = len(blocks)
    if nb == 0:
        return
    arr = np.ascontiguousarray(band.arr, np.int32)
    bh, bw = arr.shape
    caps_arr = None
    if only is not None:
        caps_arr = np.full(nb, -1, np.int64)      # -1 = native skip
        for i, cb in enumerate(blocks):
            if id(cb) in only:
                caps_arr[i] = caps.get(id(cb), 0) if caps else 0
    elif caps:
        caps_arr = np.zeros(nb, np.int64)
        for i, cb in enumerate(blocks):
            caps_arr[i] = caps.get(id(cb), 0)
        if not caps_arr.any():
            caps_arr = None
    out_cap = arr.size * 4 + 2048 * nb + 4096
    out = np.empty(out_cap, np.uint8)
    nbps = np.zeros(nb, np.int32)
    npasses = np.zeros(nb, np.int32)
    lens = np.zeros(nb, np.int64)
    offs = np.zeros(nb, np.int64)
    rates = np.zeros((nb, 128), np.int64)
    dists = np.zeros((nb, 128), np.float64)
    hull_n = np.zeros(nb, np.int32)
    hull_slopes = np.zeros((nb, 64), np.float64)
    hull_rates = np.zeros((nb, 65), np.int64)
    hull_picks = np.zeros((nb, 65), np.int32)
    i64p = ctypes.POINTER(ctypes.c_long)
    intp = ctypes.POINTER(ctypes.c_int)
    n = lib.jp2t1_encode_band(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), bw, bh, CB,
        blocks[0].orient_code,
        caps_arr.ctypes.data_as(i64p) if caps_arr is not None else None,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_cap,
        nbps.ctypes.data_as(intp), npasses.ctypes.data_as(intp),
        lens.ctypes.data_as(i64p), offs.ctypes.data_as(i64p),
        rates.ctypes.data_as(i64p),
        dists.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        blocks[0].weight, _TRUNC_MARGIN,
        hull_n.ctypes.data_as(intp),
        hull_slopes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hull_rates.ctypes.data_as(i64p), hull_picks.ctypes.data_as(intp),
        int(max_passes))
    if n != nb:
        raise RuntimeError('jp2t1_encode_band overflow (%d != %d)'
                           % (n, nb))
    for i, cb in enumerate(blocks):
        if only is not None and id(cb) not in only:
            continue                      # skipped block: state untouched
        npi = int(npasses[i])
        o = int(offs[i])
        cb.data = out[o:o + int(lens[i])].tobytes()
        cb.nbps = int(nbps[i])
        cb.npasses = npi
        cb.rates = rates[i, :npi]
        cb.dists = dists[i, :npi]
        cap = int(caps_arr[i]) if caps_arr is not None else 0
        short = npi < 3 * cb.nbps - 2
        cb.capped = cap > 0 and short
        cb.pass_capped = (not cb.capped and max_passes > 0
                          and npi >= max_passes and short)
        m = int(hull_n[i])
        cb.hull_rows = (hull_slopes[i, :m], hull_rates[i, :m + 1],
                        hull_picks[i, :m + 1])


def _t1_all(bands, lib, workers, target_bytes=None):
    blocks = [cb for band in bands for cb in band.blocks]
    # rate-aware work cap: when a byte target exists, almost no block's
    # passes survive PCRD beyond ~4x its fair share of the budget, so
    # stop its T1 encode there (the big speedup at high ratios).  The
    # floor keeps enough recorded passes for PCRD to rank blocks; the
    # allocator re-encodes the rare block it exhausts (see
    # _allocate_rate), so a low floor costs quality nothing.
    caps = {}
    pass_caps = {}
    # APT_T1_CAPS: auto (default policy below) | all (cap every band,
    # the r3 behavior) | off — the A/B knob for tools/t1_cap_ab.py
    cap_mode = os.environ.get('APT_T1_CAPS', 'auto')
    if target_bytes and cap_mode != 'off':
        # floor 512 (was 96): on the realistic corpus the 96-byte floor
        # sat exactly at the int8 level-3 blocks' typical chosen size,
        # so their rescue re-encoded ~35 blocks/job every page — pure
        # double work.  512 uncaps those small producers (initial +0.08
        # s/3pages, rescue -0.54) and stays byte-identical; A/B
        # 2026-08-20: floor 96 0.741 s, 256 0.712, 512 0.617 (3 pages).
        floor = int(os.environ.get('APT_T1_CAP_FLOOR', '512'))
        total_px = sum(cb.arr.size for cb in blocks) or 1
        for band in bands:
            if cap_mode == 'all':
                for cb in band.blocks:
                    caps[id(cb)] = max(
                        floor, 4 * target_bytes * cb.arr.size // total_px)
                continue
            # pack4 plane-budgeted bands (<= 7 passes): a byte cap saves
            # ~nothing and rescue-storms (measured: 1287 blocks on one
            # 8-page batch), but their FINEST plane is the expensive one
            # and final picks almost never reach it (avg chosen 0-0.1 of
            # 4-5 recorded passes, per-band pick capture 2026-08-20) —
            # pass-cap at the top two planes; the exact-boundary rescue
            # realizes the rare block that wants more.
            if band.plane_budget is not None and band.plane_budget <= 4:
                fine = int(os.environ.get('APT_T1_FINE_PASSES', '4'))
                if fine > 0:
                    pass_caps[id(band)] = fine
                continue
            # small (coarse) full-precision bands: a byte cap starves
            # them structurally (at high ratios the byte budget
            # CONCENTRATES in the few coarse blocks — an LL block takes
            # ~target/16 while its pixel share says ~96 B, so byte caps
            # rescue-stormed).  But their DEEP planes are pure waste:
            # on the realistic corpus these blocks record ~41-53 passes
            # and PCRD keeps ~0-12 (measured 2026-08-20, per-band pick
            # capture).  Cap by PASS COUNT instead — the top
            # APT_T1_COARSE_PLANES (default 7) bit planes, 19 passes —
            # which cuts the dense deep planes where the cost lives
            # while the starved rescue still guarantees the uncapped
            # allocation when a block wants more.
            if band.arr.dtype != np.int8 and len(band.blocks) <= 64:
                pass_caps[id(band)] = 3 * int(os.environ.get(
                    'APT_T1_COARSE_PLANES', '7')) - 2
                continue
            for cb in band.blocks:
                caps[id(cb)] = max(
                    floor, 4 * target_bytes * cb.arr.size // total_px)
    import time as _t
    _i0 = _t.time()

    def enc(band):
        _encode_band_blocks(lib, band, caps,
                            max_passes=pass_caps.get(id(band), -1))

    if workers > 1 and len(bands) > 1:
        # multi-core hosts: band-level calls release the GIL for their
        # whole duration, so a thread per band parallelizes in C++
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(enc, bands))
    else:
        for band in bands:
            enc(band)
    _stat('initial', _t.time() - _i0, len(blocks))
    return blocks


def _packet(bands_at_res, mb):
    """One packet (single layer, one precinct): header + body bytes.
    bands_at_res: list of _Band in HL, LH, HH (or [LL]) order.

    The header (tag trees + stuffed bit writer) is generated by
    native/jp2t1.cpp:jp2t2_packet_header; the Python path below is the
    readable reference and byte-identity oracle (APT_T2_IMPL=py,
    tests/test_jp2tpu.py)."""
    if not any(band.blocks for band in bands_at_res):
        return b''                      # no blocks at all: no packet
    included = [cb for band in bands_at_res for cb in band.blocks
                if cb.chosen > 0 and len(cb.chosen_bytes)]
    if not included:
        bw = _BitWriter()
        bw.put(0)                       # empty packet
        return bw.flush()

    if _lib is not None and os.environ.get('APT_T2_IMPL') != 'py':
        bands = [b for b in bands_at_res if b.blocks]
        nb_tot = sum(len(b.blocks) for b in bands)
        nxs = np.array([b.nx for b in bands], np.int32)
        nys = np.array([b.ny for b in bands], np.int32)
        incl = np.zeros(nb_tot, np.uint8)
        zbp = np.zeros(nb_tot, np.int32)
        np_ = np.zeros(nb_tot, np.int32)
        lens = np.zeros(nb_tot, np.int64)
        body = []
        pos = 0
        for band in bands:
            mbb = mb[band]
            for i, cb in enumerate(band.blocks):
                if cb.chosen > 0 and len(cb.chosen_bytes):
                    incl[pos + i] = 1
                    zbp[pos + i] = max(0, mbb - cb.nbps)
                    np_[pos + i] = cb.chosen
                    lens[pos + i] = len(cb.chosen_bytes)
                    body.append(cb.chosen_bytes)
            pos += len(band.blocks)
        # worst-case header bits per included block: two tag-tree
        # walks (<= ~2 bits/level + threshold zeros), npasses (<= 16),
        # Lblock ones + length (<= ~40) — 64 bytes/block is generous
        cap = 64 * nb_tot + 1024
        out = np.empty(cap, np.uint8)
        intp = ctypes.POINTER(ctypes.c_int)
        n = _lib.jp2t2_packet_header(
            len(bands), nxs.ctypes.data_as(intp),
            nys.ctypes.data_as(intp),
            incl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            zbp.ctypes.data_as(intp), np_.ctypes.data_as(intp),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError('jp2t2_packet_header overflow')
        return out[:n].tobytes() + b''.join(body)

    bw = _BitWriter()
    bw.put(1)
    body = bytearray()
    for band in bands_at_res:
        if not band.blocks:
            continue
        incl = _TagTree(band.nx, band.ny)
        zbt = _TagTree(band.nx, band.ny)
        for i, cb in enumerate(band.blocks):
            x, y = i % band.nx, i // band.nx
            ok = cb.chosen > 0 and len(cb.chosen_bytes)
            incl.set(x, y, 0 if ok else 1)
            zbt.set(x, y, max(0, mb[band] - cb.nbps) if ok else 0)
        incl.finalize()
        zbt.finalize()
        lblock = {}
        for i, cb in enumerate(band.blocks):
            x, y = i % band.nx, i // band.nx
            ok = cb.chosen > 0 and len(cb.chosen_bytes)
            incl.encode(bw, x, y, 1)
            if not ok:
                continue
            zbt.encode(bw, x, y, max(0, mb[band] - cb.nbps) + 1)
            _npasses_code(bw, cb.chosen)
            lb = lblock.get(i, 3)
            ln = len(cb.chosen_bytes)
            full = lb + int(math.floor(math.log2(cb.chosen)))
            need = max(1, ln.bit_length())
            while full < need:
                bw.put(1)
                lb += 1
                full += 1
            bw.put(0)
            lblock[i] = lb
            bw.put_bits(ln, full)
            body += cb.chosen_bytes
    return bw.flush() + bytes(body)


def _assemble(w, h, ncomp, levels, guard, comp_bands, mct):
    """Markers + tile + packets (LRCP, one layer, one precinct/res)."""
    out = bytearray()
    out += b'\xff\x4f'                                   # SOC
    # SIZ
    siz = struct.pack('>HIIIIIIIIH', 0, w, h, 0, 0, w, h, 0, 0, ncomp)
    for _ in range(ncomp):
        siz += struct.pack('>BBB', 7, 1, 1)
    out += b'\xff\x51' + struct.pack('>H', 2 + len(siz)) + siz
    # COD
    cod = struct.pack('>BBHBBBBBB', 0, 0, 1, 1 if mct else 0,
                      levels, 4, 4, 0, 0)
    out += b'\xff\x52' + struct.pack('>H', 2 + len(cod)) + cod
    # QCD (scalar expounded; same for every component)
    qcd = struct.pack('>B', 0x02 | (guard << 5))
    for band in comp_bands[0]:
        qcd += struct.pack('>H', (band.eps << 11) | band.mu)
    out += b'\xff\x5c' + struct.pack('>H', 2 + len(qcd)) + qcd

    # packets, LRCP: layer(1) -> res -> comp
    mb = {band: guard + band.eps - 1
          for bands in comp_bands for band in bands}
    packets = bytearray()
    for r in range(levels + 1):
        for c in range(ncomp):
            bands = comp_bands[c]
            if r == 0:
                at_res = [bands[0]]
            else:
                at_res = bands[1 + 3 * (r - 1): 1 + 3 * r]
            packets += _packet(at_res, mb)

    psot = 12 + 2 + len(packets)
    out += b'\xff\x90' + struct.pack('>HHIBB', 10, 0, psot, 0, 1)  # SOT
    out += b'\xff\x93'                                   # SOD
    out += packets
    out += b'\xff\xd9'                                   # EOC
    return bytes(out)


def _jp2_wrap(codestream, w, h, ncomp):
    def box(tag, payload):
        return struct.pack('>I', 8 + len(payload)) + tag + payload

    sig = box(b'jP  ', b'\x0d\x0a\x87\x0a')
    ftyp = box(b'ftyp', b'jp2 ' + b'\x00' * 4 + b'jp2 ')
    ihdr = box(b'ihdr', struct.pack('>IIHBBBB', h, w, ncomp, 7, 7, 0, 0))
    colr = box(b'colr', struct.pack('>BBBI', 1, 0, 0,
                                    16 if ncomp == 3 else 17))
    jp2h = box(b'jp2h', ihdr + colr)
    jp2c = box(b'jp2c', codestream)
    return sig + ftyp + jp2h + jp2c


def _host_encode(qbands, w, h, ncomp, levels, base_delta, ratio, rgb,
                 lib, workers, wrap_jp2, shifts=None, kplanes=None,
                 refetch=None, page_idx=None):
    """Tier-1 + rate allocation + Tier-2 for one image's quantized
    subbands (numpy).

    kplanes/refetch/page_idx: pack4 plane-budget support — kplanes maps
    band index -> planes shipped; when rate allocation exhausts a
    band's shipped planes (a block coded all 3K-2 available passes and
    the threshold still wanted it whole), ``refetch(k)`` pulls that
    band at int8 from the device and the band is re-encoded at its
    smaller shift before assembly.  The budget is a transfer
    optimization, never a quality ceiling."""
    base_layout = band_layout(levels, base_delta)
    shifts = [int(s) for s in shifts] if shifts is not None \
        else [0] * len(base_layout)

    def adjusted(k):
        # requantized band k uses step 2^s * delta_b (exact trunc-shift
        # on device/host), so its QCD exponent drops by s — a plain
        # standard coarser quantizer, nothing custom on the decode side
        orient, level, gain, eps, mu, step = base_layout[k]
        s = shifts[k]
        if s and eps - s < 0:
            raise ValueError('pack shift %d exceeds eps %d' % (s, eps))
        return (orient, level, gain, eps - s, mu, step * (1 << s))

    comp_bands = [[_Band(*adjusted(k), q) for k, q in enumerate(qb)]
                  for qb in qbands]
    if kplanes:
        for bands in comp_bands:
            for k, K in kplanes.items():
                bands[k].plane_budget = K

    target = None
    if ratio is not None and ratio > 1:
        target = int(h * w * ncomp / float(ratio))
    all_bands = [band for bands in comp_bands for band in bands]
    _t1_all(all_bands, lib, workers, target_bytes=target)

    for _round in range(2):
        blocks = [cb for bands in comp_bands
                  for band in bands for cb in band.blocks]
        if target is not None:
            _allocate_rate(blocks, target, lib, workers,
                           bands=all_bands)
        else:
            for cb in blocks:
                cb.chosen = cb.npasses
                cb.chosen_bytes = cb.data

        if _round or target is None or refetch is None or not kplanes:
            break
        # pack4 starvation check: a band whose shipped planes the
        # allocator fully consumed may have wanted deeper data
        starved = []
        for k, K in sorted(kplanes.items()):
            if shifts[k] <= 0:
                continue
            hungry = any(
                cb.nbps >= K and cb.npasses
                and cb.chosen >= cb.npasses
                and cb.npasses >= 3 * cb.nbps - 2
                for bands in comp_bands for cb in bands[k].blocks)
            if hungry:
                starved.append(k)
        if not starved:
            break
        for k in starved:
            vals, s8 = refetch(k)
            shifts[k] = s8
            for c in range(ncomp):
                q = vals[c] if page_idx is None else vals[c][page_idx]
                comp_bands[c][k] = _Band(*adjusted(k),
                                         np.asarray(q, np.int32))
            _stat('pack4_refetch', 0.0, 1)
            for c in range(ncomp):
                _encode_band_blocks(lib, comp_bands[c][k])

    # guard bits: Mb = guard + eps - 1 must cover every block's planes
    guard = 2
    for bands in comp_bands:
        for band in bands:
            for cb in band.blocks:
                guard = max(guard, cb.nbps - band.eps + 1)
    if guard > 7:
        # A silent clamp here would make Mb undercount the coded planes
        # and desync the decoder into a corrupt block; unreachable for
        # 8-bit input with the current band norms, so fail loudly if a
        # future base_delta/norm change ever trips it.
        raise ValueError(
            'jp2tpu: required guard bits %d > 7 (eps too small for a '
            'block with %d bitplanes); renormalize base_delta' % (
                guard, max(cb.nbps for bands in comp_bands
                           for b in bands for cb in b.blocks)))

    stream = _assemble(w, h, ncomp, levels, guard, comp_bands, rgb)
    return _jp2_wrap(stream, w, h, ncomp) if wrap_jp2 else stream


_PACK4_K_FINE = 3


def _pack4_sets(nb, levels):
    """Band-index sets for the pack4 plane budgets: (k3, k7) = finest
    two resolutions (K=_PACK4_K_FINE, nibble) and the third-finest
    (K=7, int8)."""
    n3 = 3 * min(2, levels)
    n7 = 3 * min(1, max(0, levels - 2))
    return (list(range(nb - n3, nb)),
            list(range(nb - n3 - n7, nb - n3)))


def _packK_shifts_np(qbands, layout, kmap):
    """Host twin of the pack4 shift choice: per-band smallest shift
    making max|q| >> s <= 2^K - 1, clamped to the band's eps."""
    nb = len(qbands[0])
    shifts = np.zeros(nb, np.int32)
    for k, K in kmap.items():
        mx = max(int(np.abs(qb[k]).max()) if qb[k].size else 0
                 for qb in qbands)
        s = 0
        while (mx >> s) > (1 << K) - 1:
            s += 1
        shifts[k] = min(s, int(layout[k][3]))
    return shifts


def _packK_apply_np(qbands, shifts, kmap):
    out = []
    for qb in qbands:
        comp = []
        for k, q in enumerate(qb):
            K = kmap.get(k)
            if K is None:
                comp.append(np.asarray(q))
            else:
                s = int(shifts[k])
                comp.append((np.sign(q) *
                             np.minimum(np.abs(q) >> s, (1 << K) - 1)
                             ).astype(np.int8))
        out.append(comp)
    return out


def _pack8_shifts_np(qbands, n_fine, layout):
    """Host-side twin of the device shift choice (native-transform
    path): same maxabs -> same shifts (incl. the eps clamp) ->
    identical streams."""
    nb = len(qbands[0])
    shifts = np.zeros(nb, np.int32)
    for k in range(nb - n_fine, nb):
        mx = max(int(np.abs(qb[k]).max()) if qb[k].size else 0
                 for qb in qbands)
        s = 0
        while (mx >> s) > 127:
            s += 1
        shifts[k] = min(s, int(layout[k][3]))
    return shifts


def _pack8_apply_np(qbands, shifts, n_fine):
    nb = len(qbands[0])
    out = []
    for qb in qbands:
        comp = []
        for k, q in enumerate(qb):
            if k >= nb - n_fine:
                s = int(shifts[k])
                comp.append((np.sign(q) *
                             np.minimum(np.abs(q) >> s, 127)
                             ).astype(np.int8))
            else:
                comp.append(np.asarray(q))
        out.append(comp)
    return out


class _AsyncMeta(dict):
    """Transform meta whose 'shifts' entry is populated by the
    background drain thread: reading it blocks until the drain ran.
    Every in-tree consumer calls fetch() (which waits) before touching
    meta, but a future caller reading meta['shifts'] first would
    otherwise see None and emit a stream whose QCD exponents don't
    match the pack8-requantized bands (ADVICE r3)."""

    _event = None

    def __getitem__(self, k):
        if k == 'shifts' and self._event is not None:
            self._event.wait()
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        if k == 'shifts' and self._event is not None:
            self._event.wait()
        return dict.get(self, k, default)


def encode_jp2_from_qbands(page_qbands, meta, ratio=None, workers=None,
                           wrap_jp2=True, page_idx=None):
    """Stage 2: Tier-1 + rate allocation + Tier-2 for one page's
    quantized subbands (from transform_jp2_batch).  page_idx selects
    this page in the batch for the pack4 starvation refetch (the
    refetched device band carries the whole batch)."""
    lib = _get_lib()
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    return _host_encode(page_qbands, meta['w'], meta['h'],
                        meta['ncomp'], meta['levels'],
                        meta['base_delta'], ratio, meta['rgb'], lib,
                        workers, wrap_jp2,
                        shifts=meta.get('shifts'),
                        kplanes=meta.get('kplanes'),
                        refetch=meta.get('refetch'),
                        page_idx=page_idx)
