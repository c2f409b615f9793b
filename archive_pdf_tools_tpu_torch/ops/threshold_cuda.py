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

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises.  ``blur_sauvola.launches`` counts the kernel launches.
"""

import ctypes

import torch

from ..utils import cudabuild
from .sauvola import sauvola_mask, sauvola_constants
from .sigma import symmetric_index

MAX_BLUR_RADIUS = 48             # supports sigma_est up to ~120
# static tap radii; the smallest one covering a batch is used (the MAC
# cost is linear in it)
RADIUS_BUCKETS = (4, 8, 16, 48)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {'apt_blur_sauvola': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _F, _F, _P]}

# two uint32 prefix rows per CTA in at most 227 KB of shared memory
MAX_WIDTH = (227 * 1024) // 8 - 512
# the window sum of squares (<= 65025 * window^2) is exact in uint32
MAX_WINDOW = 255


def vertical_pass(x, taps):
    """f32 (B, H, W) -> its vertical MAC with per-page taps (B, 2r+1)."""
    k = taps.shape[1]
    r = (k - 1) // 2
    h = x.shape[1]
    xp = x[:, symmetric_index(h, r, r, x.device)]
    v = torch.zeros_like(x)
    for t in range(k):
        v = v + taps[:, t, None, None] * xp[:, t:t + h]
    return v


def horizontal_pass(v, taps):
    """f32 (B, H, W) -> its horizontal MAC with per-page taps."""
    k = taps.shape[1]
    r = (k - 1) // 2
    w = v.shape[2]
    vp = v[:, :, symmetric_index(w, r, r, v.device)]
    o = torch.zeros_like(v)
    for t in range(k):
        o = o + taps[:, t, None, None] * vp[:, :, t:t + w]
    return o


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
    b, h, w = img.shape
    if w > MAX_WIDTH:
        raise ValueError('blur_sauvola: width %d exceeds the kernel limit '
                         '%d' % (w, MAX_WIDTH))
    radius = (taps.shape[1] - 1) // 2
    km1, k2 = sauvola_constants(k, R)
    lib = cudabuild.load('blur_sauvola', _SIGNATURES)
    out = torch.empty(img.shape, dtype=torch.bool, device=img.device)
    vtmp = torch.empty(img.shape, dtype=torch.float32, device=img.device)
    blur = torch.empty_like(img)
    scol = torch.empty(img.shape, dtype=torch.int32, device=img.device)
    qcol = torch.empty_like(scol)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.apt_blur_sauvola(
            img.data_ptr(), taps.data_ptr(), out.data_ptr(),
            vtmp.data_ptr(), blur.data_ptr(), scol.data_ptr(),
            qcol.data_ptr(), b, h, w, radius, int(window), float(km1),
            float(k2), stream)
    cudabuild.check(err, 'blur_sauvola')
    blur_sauvola.launches += 1
    return out


blur_sauvola.launches = 0
