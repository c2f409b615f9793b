"""Separable blur filters with scipy.ndimage's semantics, as torch ops:
the counterpart of the JAX package's ``ops/filters.py`` (XLA ops there,
not a Pallas kernel).

The reference leans on scipy for ``ndimage.gaussian_filter`` inside
``partial_blur`` (``mrc.py:111-150``) and ``ndimage.uniform_filter``
inside ``partial_boxblur`` (``mrc.py:153-185``).  scipy's defaults are
kept: truncate=4.0 (radius ``int(truncate*sigma + 0.5)``), border mode
'reflect', which repeats the edge sample (numpy's 'symmetric'; torch's
``F.pad(mode='reflect')`` does not, so the pad is built by index), and
separable 1-D passes.  The filters work on the trailing two axes and
broadcast over leading ones.  Each pass is explicit float32
multiply-adds, taps ascending, so the result is the same on every device
(no convolution library, so no TF32).
"""

import numpy as np
import torch

from .sigma import symmetric_index


def gaussian_kernel1d(sigma, radius):
    """scipy.ndimage._gaussian_kernel1d (order 0): sampled, normalised."""
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float32)


def _correlate1d(x, kernel, dim):
    """Correlate float32 ``x`` along ``dim`` with ``kernel``, the border
    mirrored with the edge sample repeated."""
    x = x.movedim(dim, -1)
    k = len(kernel)
    lo = k // 2
    n = x.shape[-1]
    xp = x[..., symmetric_index(n, lo, k - 1 - lo, x.device)]
    out = None
    for j in range(k):
        term = float(kernel[j]) * xp[..., j:j + n]
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def gaussian_filter(img, sigma, truncate=4.0):
    """scipy.ndimage.gaussian_filter over the last two axes -> float32."""
    radius = int(float(truncate) * float(sigma) + 0.5)
    k = gaussian_kernel1d(float(sigma), radius)
    out = _correlate1d(img.to(torch.float32), k, -2)
    return _correlate1d(out, k, -1)


def uniform_filter(img, size=5):
    """scipy.ndimage.uniform_filter over the last two axes -> float32."""
    k = np.full((size,), 1.0 / size, np.float32)
    out = _correlate1d(img.to(torch.float32), k, -2)
    return _correlate1d(out, k, -1)


def _partial(mask, img, blur):
    """Shared core of partial_blur/partial_boxblur (``mrc.py:111-185``):
    blur img*mask and mask, divide (+1e-5), truncate to uint8, keep the
    original pixels where the mask is set.  Channels (if any) ride a
    leading axis through the blur."""
    maskf = mask.to(torch.float32)
    weights = blur(maskf) + 0.00001
    if img.dim() == mask.dim() + 1:                          # (..., H, W, C)
        chan = img.movedim(-1, 0).to(torch.float32)          # (C, ..., H, W)
        num = blur(chan * maskf[None])
        out = (num / weights[None]).movedim(0, -1)
        out = out.clamp(0, 255).to(torch.uint8)
        return torch.where(mask[..., None], img, out)
    num = blur(img.to(torch.float32) * maskf)
    out = (num / weights).to(torch.uint8)
    return torch.where(mask, img, out)


def partial_blur(mask, img, sigma=5):
    """Gaussian variant (``mrc.py:111-150``)."""
    return _partial(mask, img, lambda a: gaussian_filter(a, float(sigma)))


def partial_boxblur(mask, img, size=5):
    """Uniform variant (``mrc.py:153-185``)."""
    return _partial(mask, img, lambda a: uniform_filter(a, int(size)))
