"""JPEG2000 forward transform, plain PyTorch version: DC shift (or the
exact int32 ICT), the L-level CDF 9/7 lifting DWT and the per-band
deadzone quantiser.

Counterpart of the JAX package's ``codecs/jp2tpu.py:_device_transform``
(``:260-308``, XLA ops) and of ``native/jp2t1.cpp:jp2dwt_quantize``;
the three agree bit for bit.  That needs each lifting update to round
once, as the fused ``fmaf(coef, a + b, dst)`` of ``Lift1D`` does, where
eager torch would round ``dst + coef * s`` twice: ``_fma`` gives the
correctly rounded float32 result from float64 arithmetic.  The
low/high scalings (``* f32(1/K)``, ``* K``) and the quantiser's
``* f32(1/step)`` stay separate float32 multiplies, and the quantised
value is truncated toward zero.

This is the CPU path of ``ops/dwt97_cuda.dwt97`` and its kernel's oracle
on the card.
"""

import numpy as np
import torch

from ..codecs.jp2host import (ALPHA, BETA, GAMMA, DELTA, K, ICT_FIX,
                              band_layout)

# the float32 values the XLA and native transforms use
_F32 = [float(np.float32(c)) for c in (ALPHA, BETA, GAMMA, DELTA)]
K_F32 = float(np.float32(K))
INV_K_F32 = float(np.float32(1.0 / K))


def _fma(c, s, d, read=bool):
    """float32 ``fma(c, s, d)`` with one rounding.  ``c * s`` is exact in
    float64 (24 x 24 bits); the float64 sum with ``d`` is rounded to odd
    (one ulp toward the exact sum when TwoSum finds an error and the
    rounded sum's last bit is even), so the cast to float32 rounds the
    exact result once.  ``read`` brings the device's flag of whether any
    sum needs that ulp to the host (a caller times it)."""
    p = s.to(torch.float64) * c
    d = d.to(torch.float64)
    t = p + d
    bb = t - p
    err = (p - (t - bb)) + (d - bb)
    fix = (err != 0) & ((t.view(torch.int64) & 1) == 0)
    if read(fix.any()):
        toward = torch.where(err > 0, torch.inf, -torch.inf).to(t.dtype)
        t = torch.where(fix, torch.nextafter(t, toward), t)
    return t.to(torch.float32)


def _lift(x, dim):
    """One 9/7 analysis level along ``dim``: (low, high) with lengths
    ceil(n/2), floor(n/2), with the whole-sample symmetric extension of
    ``jp2tpu._lift_indices``."""
    n = x.shape[dim]
    ne, no = (n + 1) // 2, n // 2
    dev = x.device
    even = x.index_select(dim, torch.arange(0, n, 2, device=dev))
    odd = x.index_select(dim, torch.arange(1, n, 2, device=dev))
    if no:
        er = torch.clamp(torch.arange(no, device=dev) + 1, max=ne - 1)
        ol = torch.clamp(torch.arange(ne, device=dev) - 1, min=0)
        orr = torch.clamp(torch.arange(ne, device=dev), max=no - 1)
        a, b, g, d = _F32

        def from_even():
            return even.narrow(dim, 0, no) + even.index_select(dim, er)

        def from_odd():
            return odd.index_select(dim, ol) + odd.index_select(dim, orr)

        odd = _fma(a, from_even(), odd)
        even = _fma(b, from_odd(), even)
        odd = _fma(g, from_even(), odd)
        even = _fma(d, from_odd(), even)
    return even * INV_K_F32, odd * K_F32


def components(imgs):
    """uint8 (B, H, W) or (B, H, W, 3) -> the float32 (B, H, W) planes
    the DWT runs on: the DC shift, or the exact int32 ICT (2^-16 fixed
    point; |sum| <= 2^23, so the float32 conversion is exact)."""
    if imgs.dim() == 3:
        return [imgs.to(torch.float32) - 128.0]
    xi = imgs.to(torch.int32) - 128
    r, g, b = xi[..., 0], xi[..., 1], xi[..., 2]
    return [(c[0] * r + c[1] * g + c[2] * b).to(torch.float32) * 2.0 ** -16
            for c in ICT_FIX]


def dwt97(imgs, levels, base_delta):
    """uint8 (B, H, W) gray or (B, H, W, 3) RGB -> one tuple per
    component of the 3L+1 int32 (B, bh, bw) quantised bands in
    codestream order (LL, then HL, LH, HH per level, coarsest first)."""
    layout = band_layout(levels, float(base_delta))
    inv = [float(np.float32(1.0 / m[5])) for m in layout]
    out = []
    for comp in components(imgs):
        ll, details = comp, []
        for _ in range(levels):
            lo_r, hi_r = _lift(ll, -2)          # vertical, then horizontal
            ll, hl = _lift(lo_r, -1)
            lh, hh = _lift(hi_r, -1)
            details.append((hl, lh, hh))
        bands = [ll] + [b for lvl in reversed(details) for b in lvl]
        out.append(tuple((b * s).to(torch.int32) for b, s in zip(bands, inv)))
    return tuple(out)
