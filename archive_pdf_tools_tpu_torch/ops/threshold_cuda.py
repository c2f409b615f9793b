"""Noise-adaptive pre-blur + global Sauvola: wrapper of the hand-written
CUDA kernel ``csrc/blur_sauvola.cu`` (the port of
``ops/threshold_pallas.py``), and its plain PyTorch version.

The plain version is the JAX package's XLA form
(``mrc/decompose.py:global_threshold_input`` + ``global_threshold``):
a separable blur with per-page float32 taps and symmetric borders,
truncated to uint8, then ``ops/sauvola.sauvola_mask``.  The blur uses one
fixed order, shared with the kernel: vertical, then horizontal, taps
ascending from 0, each product and sum rounded separately (shifted
multiply-adds, never a convolution library, so TF32 never enters).

The kernel makes two launches: the blur over tiles of ``BLUR_TILE``
pixels with a halo of r, into a uint8 page, then the Sauvola walk over
column strips and runs of rows (``sauvola_plan``), so a page of any
width is taken.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.  ``blur_sauvola.launches`` counts the
calls that launch it.
"""

import ctypes

import torch

from ..utils import cudabuild
from .sauvola import sauvola_constants, sauvola_mask, sauvola_window
from .sigma import symmetric_index

MAX_BLUR_RADIUS = 48             # supports sigma_est up to ~120
# static tap radii; the smallest one covering a batch is used (the MAC
# cost is linear in it)
RADIUS_BUCKETS = (4, 8, 16, 48)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {'apt_blur_sauvola': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                    _F, _I, _I, _P]}

# the window sum of squares (<= 65025 * window^2) is exact in uint32
MAX_WINDOW = 255
# output rows and columns of a CTA of the blur launch (fixed in the
# kernel: 4 rows and 4 columns a thread of 8 x 32)
BLUR_TILE = (32, 128)
# columns a CTA of the Sauvola walk keeps sums of (its strip and the
# window's halo, 4 a thread), and the rows it walks
WALK_COLS = 1024
WALK_ROWS = 96


def sauvola_plan(window, walk_cols=WALK_COLS, walk_rows=WALK_ROWS):
    """(strip, run): the output columns and rows of a CTA of the Sauvola
    walk.  Its column sums span the strip plus the window's reach, o-1
    columns to the left and u to the right (window - 1 together)."""
    if walk_cols < window or walk_rows < 1:
        raise ValueError('sauvola_plan: %d columns cannot hold a window of '
                         '%d' % (walk_cols, window))
    return walk_cols - (window - 1), walk_rows


def vertical_mac(xp, taps, h):
    """f32 (B, h + 2r, W), rows already extended by r each side -> the
    vertical MAC with per-page taps (B, 2r+1), (B, h, W)."""
    v = torch.zeros_like(xp[:, :h])
    for t in range(taps.shape[1]):
        v = v + taps[:, t, None, None] * xp[:, t:t + h]
    return v


def horizontal_mac(vp, taps, w):
    """f32 (B, H, w + 2r), columns already extended -> (B, H, w)."""
    o = torch.zeros_like(vp[:, :, :w])
    for t in range(taps.shape[1]):
        o = o + taps[:, t, None, None] * vp[:, :, t:t + w]
    return o


def vertical_pass(x, taps):
    """f32 (B, H, W) -> its vertical MAC with per-page taps (B, 2r+1),
    symmetric borders."""
    r = (taps.shape[1] - 1) // 2
    h = x.shape[1]
    return vertical_mac(x[:, symmetric_index(h, r, r, x.device)], taps, h)


def horizontal_pass(v, taps):
    """f32 (B, H, W) -> its horizontal MAC with per-page taps."""
    r = (taps.shape[1] - 1) // 2
    w = v.shape[2]
    return horizontal_mac(v[:, :, symmetric_index(w, r, r, v.device)], taps,
                          w)


def truncate_u8(o):
    """f32 -> uint8 truncated like ``astype(uint8)``, clamped to 0-255."""
    return o.to(torch.int32).clamp(0, 255).to(torch.uint8)


def separable_blur(img, taps):
    """img uint8 (B, H, W), taps f32 (B, 2r+1) -> blurred uint8 (B, H, W),
    truncated like ``astype(uint8)``."""
    x = img.to(torch.float32)
    return truncate_u8(horizontal_pass(vertical_pass(x, taps), taps))


def blur_sauvola_plain(img, taps, window, k=0.34, R=128.0):
    return sauvola_mask(separable_blur(img, taps), window, window, k, R)


def _check(img, taps, window, k):
    if img.dtype != torch.uint8 or img.dim() != 3:
        raise TypeError('blur_sauvola: need a uint8 (B, H, W) image, got '
                        '%s %s' % (img.dtype, tuple(img.shape)))
    if taps.dtype != torch.float32 or taps.dim() != 2 \
            or taps.shape[0] != img.shape[0] or taps.shape[1] % 2 != 1:
        raise ValueError('blur_sauvola: taps must be f32 (B, 2r+1), got '
                         '%s %s' % (taps.dtype, tuple(taps.shape)))
    if taps.device != img.device:
        raise ValueError('blur_sauvola: img on %s, taps on %s'
                         % (img.device, taps.device))
    if window < 1 or window % 2 != 1:
        raise ValueError('blur_sauvola: window must be odd, got %d' % window)
    if window > MAX_WINDOW:
        raise ValueError('blur_sauvola: window %d exceeds the kernel limit '
                         '%d (uint32 sum of squares)' % (window, MAX_WINDOW))
    if k < 0:
        raise ValueError('blur_sauvola: k >= 0 only (global threshold)')


def launch(lib, img, taps, out, blur, window, k, R):
    """Call ``apt_blur_sauvola`` of lib (the shipped build or an ablation
    build) on the current stream; blur: the uint8 page scratch or None.
    Returns its cudaError_t."""
    b, h, w = img.shape
    km1, k2 = sauvola_constants(k, R)
    strip, run = sauvola_plan(window)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        return lib.apt_blur_sauvola(
            img.data_ptr(), taps.data_ptr(), out.data_ptr(),
            None if blur is None else blur.data_ptr(), b, h, w,
            (taps.shape[1] - 1) // 2, int(window), float(km1), float(k2),
            strip, run, stream)


def blur_sauvola(img, taps, window, k=0.34, R=128.0):
    """Blur each page of img with its taps, truncate to uint8 and return
    the bool (B, H, W) Sauvola ink mask (True = ink)."""
    _check(img, taps, window, k)
    if img.device.type == 'cpu':
        return blur_sauvola_plain(img, taps, window, k, R)
    if img.device.type != 'cuda':
        raise ValueError('blur_sauvola: unsupported device %s' % img.device)
    if not (img.is_contiguous() and taps.is_contiguous()):
        raise ValueError('blur_sauvola: inputs must be contiguous')
    lib = cudabuild.load('blur_sauvola', _SIGNATURES)
    out = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    err = launch(lib, img, taps, out, torch.empty_like(img), window, k, R)
    cudabuild.check(err, 'blur_sauvola')
    blur_sauvola.launches += 1
    return out


blur_sauvola.launches = 0


def threshold_image(img, dpi, k=0.34):
    """``mrc.threshold_image`` (``mrc.py:58-87``) on a uint8 (B, H, W)
    batch: the window from the DPI, R=128 -> bool ink mask.  On a CUDA
    tensor this is the blur + Sauvola kernel with identity taps (no
    blur); on a CPU tensor ``sauvola_mask``."""
    win = sauvola_window(dpi)
    if img.device.type == 'cpu':
        return sauvola_mask(img, win, win, k, 128.0)
    # identity taps in the smallest bucket: x * 1 plus zeros is x, so
    # the blur changes no pixel
    r = RADIUS_BUCKETS[0]
    ident = torch.zeros((img.shape[0], 2 * r + 1), dtype=torch.float32,
                        device=img.device)
    ident[:, r] = 1.0
    return blur_sauvola(img.contiguous(), ident, win, k)
