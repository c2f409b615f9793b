"""Antialiased resize as two matrix products (PIL-equivalent weights);
counterpart of the JAX package's ``ops/resize.py``.

The reference downsamples with PIL: whole-image ``thumbnail(...,
resample=LANCZOS, reducing_gap=None)`` (``recode.py:370``) and per-layer
``thumbnail(...)`` with the BICUBIC default (``mrc.py:427,461``).  PIL's
resample is a separable filter whose support scales with the ratio, so
each axis is a dense (out, in) float32 matrix and the resize is two
``torch.einsum`` products, with PIL's uint8 round-half-up quantisation
between the passes.  Values match PIL within +-1 LSB; ``thumbnail_size``
reproduces PIL's aspect-fit rounding, so output dimensions are exact.

The products run in full float32: ``resize`` turns TF32 off for them
(``torch.backends.cuda.matmul.allow_tf32 = False``) and restores the
caller's setting after.  They are plain matrix products outside any
kernel, as in the JAX package.
"""

import contextlib
import functools
import math

import numpy as np
import torch


def _bicubic(x, a=-0.5):
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def _lanczos(x, a=3.0):
    if x == 0.0:
        return 1.0
    if abs(x) >= a:
        return 0.0
    px = math.pi * x
    return a * math.sin(px) * math.sin(px / a) / (px * px)


_FILTERS = {
    'bicubic': (_bicubic, 2.0),
    'lanczos': (_lanczos, 3.0),
    'bilinear': (lambda x: max(0.0, 1.0 - abs(x)), 1.0),
}


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size, out_size, filt='bicubic'):
    """(out_size, in_size) float32 PIL-convention resampling matrix."""
    fn, support = _FILTERS[filt]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    sup = support * fscale
    mat = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        jmin = max(int(center - sup + 0.5), 0)
        jmax = min(int(center + sup + 0.5), in_size)
        w = np.array([fn((j + 0.5 - center) / fscale)
                      for j in range(jmin, jmax)], np.float64)
        s = w.sum()
        if s != 0:
            w /= s
        mat[i, jmin:jmax] = w
    return mat


@contextlib.contextmanager
def _full_fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resize(img, out_h, out_w, filt='bicubic'):
    """Resize a uint8/float tensor (..., H, W) or (..., H, W, C) to
    (out_h, out_w), on its device."""
    # channels iff ndim>=3 and last dim looks like one (1, 3 or 4)
    chan = img.dim() >= 3 and img.shape[-1] in (1, 3, 4)
    h_ax, w_ax = (-3, -2) if chan else (-2, -1)
    in_h, in_w = img.shape[h_ax], img.shape[w_ax]
    ah = torch.from_numpy(resize_matrix(in_h, out_h, filt)).to(img.device)
    aw = torch.from_numpy(resize_matrix(in_w, out_w, filt)).to(img.device)
    is_int = not img.dtype.is_floating_point
    x = img.to(torch.float32)

    def quant(a):
        # PIL stores the intermediate pass as uint8 (round half away, clip)
        return torch.floor(a + 0.5).clamp(0, 255) if is_int else a

    with _full_fp32_matmul():
        if chan:
            y = quant(torch.einsum('pw,...hwc->...hpc', aw, x))
            y = quant(torch.einsum('oh,...hpc->...opc', ah, y))
        else:
            y = quant(torch.einsum('pw,...hw->...hp', aw, x))
            y = quant(torch.einsum('oh,...hp->...op', ah, y))
    return y.to(img.dtype) if is_int else y


def thumbnail_size(w, h, box_w, box_h):
    """PIL Image.thumbnail aspect-fit target size (PIL/Image.py semantics).
    Returns None when the image already fits (PIL leaves it untouched)."""
    x, y = math.floor(box_w), math.floor(box_h)
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def downsample_layer(img, factor, filt='bicubic'):
    """Reference layer-downsample semantics (``mrc.py:420-434``): target box
    (w//f, h//f) via int(), aspect-fit thumbnail, no-op when degenerate.
    Returns (resized_or_original, did_resize)."""
    chan = img.dim() >= 3 and img.shape[-1] in (1, 3, 4)
    h, w = ((img.shape[-3], img.shape[-2]) if chan
            else (img.shape[-2], img.shape[-1]))
    bw, bh = int(w / factor), int(h / factor)
    if bw <= 0 or bh <= 0:
        return img, False
    tgt = thumbnail_size(w, h, bw, bh)
    if tgt is None:
        return img, True
    tw, th = tgt
    return resize(img, th, tw, filt), True
