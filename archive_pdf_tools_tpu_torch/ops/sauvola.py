"""Sauvola adaptive binarisation, plain PyTorch (counterpart of the JAX
package's ``ops/sauvola.py``; reference ``cython/sauvola.pyx:29-222``).

For every pixel the clamped window rows ``[y-o+1, y+u]`` x cols
``[x-l+1, x+r]`` (``o=(wh+1)//2, u=wh//2, l=(ww+1)//2, r=ww//2``) give an
integer mean and E[x^2] by floor division (the reference's C integer
division), then the squared-form test runs in float32, exactly like the
JAX package (which matches the reference's float64 test on all but
genuinely borderline pixels):

    t = px + mean*(k-1)
    k >= 0:  ink  <=>  t <= 0  or  t*t <= mean^2 * (k/R)^2 * var
    k <  0:  ink  <=>  t <= 0  and t*t >= mean^2 * (k/R)^2 * var

Returns the mask polarity (True = ink).
"""

import functools

import numpy as np
import torch

from .window import box_sum_2d


def sauvola_window(dpi):
    """Window size policy of the reference (``mrc.py:70-75``): dpi/4
    rounded up to odd; 51 when dpi is unknown."""
    if dpi is None:
        return 51
    w = int(dpi / 4)
    if w % 2 == 0:
        w += 1
    return w


def _offsets(window_width, window_height):
    l = (window_width + 1) // 2
    r = window_width // 2
    o = (window_height + 1) // 2
    u = window_height // 2
    # inclusive [y-o+1, y+u] -> half-open [y-o+1, y+u+1)
    return (-o + 1, u + 1), (-l + 1, r + 1)


@functools.lru_cache(maxsize=None)
def sauvola_constants(k, R=128.0):
    """(k-1, k*k/R/R) in float32, rounded in the JAX package's order."""
    k32, r32 = np.float32(k), np.float32(R)
    return np.float32(k32 - np.float32(1.0)), np.float32(k32 * k32 / r32 / r32)


def sauvola_counts(h, w, window_width, window_height, device):
    """int64 (h, w): the pixels of each clamped window of an h x w crop."""
    row_off, col_off = _offsets(window_width, window_height)

    def count(n, off):
        i = torch.arange(n, device=device)
        return (i + off[1]).clamp(max=n) - (i + off[0]).clamp(min=0)
    return count(h, row_off)[:, None] * count(w, col_off)[None, :]


def sauvola_sums(img, window_width, window_height):
    """Exact clamped window sums of x and x^2 (int64) of uint8 (..., H, W)."""
    row_off, col_off = _offsets(window_width, window_height)
    x = img.to(torch.int64)
    return box_sum_2d(x, row_off, col_off), box_sum_2d(x * x, row_off,
                                                       col_off)


def sauvola_test(img, s, s2, cnt, k, R=128.0):
    """The ink test of every pixel of img from its window's sums and
    count: integer mean and E[x^2] by floor division, then float32."""
    mean_i = s // cnt                       # C integer division (floor)
    var_i = s2 // cnt - mean_i * mean_i

    mean = mean_i.to(torch.float32)
    var = var_i.to(torch.float32)
    px = img.to(torch.float32)
    km1, k2 = (torch.tensor(v, dtype=torch.float32, device=img.device)
               for v in sauvola_constants(k, R))
    t = px + mean * km1
    rhs = mean * mean * k2 * var
    t2 = t * t
    if k >= 0:
        return (t <= 0.0) | (t2 <= rhs)
    return (t <= 0.0) & (t2 >= rhs)


def sauvola_mask(img, window_width, window_height, k, R=128.0):
    """Batched Sauvola mask. img: uint8 (..., H, W) -> bool (True = ink)."""
    s, s2 = sauvola_sums(img, window_width, window_height)
    cnt = sauvola_counts(img.shape[-2], img.shape[-1], window_width,
                         window_height, img.device)
    return sauvola_test(img, s, s2, cnt, k, R)
