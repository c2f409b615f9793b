"""Isotropic split-Bregman total-variation denoise (``--denoise-mask
bregman``), counterpart of the JAX package's ``ops/tv.py`` (reference
``mrc.py:90-108``, skimage's ``denoise_tv_bregman`` with weight 1.0 on
the float mask, pixels > 0.4 kept).

The same fixed 100 damped-Jacobi iterations of clamped-shift stencils in
float32, each update written in the JAX function's order of operations.
The iteration amplifies a one-ulp difference to tenths within 100 steps,
so the roundings must be the JAX function's as XLA compiles it for the
CPU, which contracts two multiply-adds into fused ones: the squared norm
``fma(gx, gx, gy * gy)`` and the Bregman update ``b = fma(-g, shrink,
g)`` (``g - d``).  ``dwt97._fma`` gives those single roundings on any
device.  The split gradients ``d`` and the Bregman terms ``b`` are kept
as two planes each (y and x) rather than a trailing axis of 2.  Torch
ops on the tensor's device; the JAX package runs these as XLA ops, not a
Pallas kernel.
"""

import torch

from .dwt97 import _fma


def _next(a, dim):
    """a[i + 1] along dim, the last row or column repeated (edge clamp)."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 1, n - 1), a.narrow(dim, n - 1, 1)], dim)


def _prev(a, dim):
    """a[i - 1] along dim, the first row or column repeated."""
    n = a.shape[dim]
    return torch.cat([a.narrow(dim, 0, 1), a.narrow(dim, 0, n - 1)], dim)


def denoise_tv_bregman(img, weight=1.0, max_iter=100):
    """img: float (..., H, W) in [0, 1]-ish -> float32 of the same shape."""
    f = img.to(torch.float32)
    lam = 2.0 * weight          # split penalty (skimage uses lambda=2w)
    mu = weight
    # a divisor on the device: the card's division by a host scalar is a
    # multiplication by its reciprocal, which rounds otherwise
    den = torch.tensor(mu + 4.0 * lam, dtype=torch.float32, device=f.device)
    u = f
    dy = torch.zeros_like(f)
    dx = torch.zeros_like(f)
    by = torch.zeros_like(f)
    bx = torch.zeros_like(f)
    for _ in range(max_iter):
        # u-update (Jacobi step of the Euler-Lagrange system)
        n4 = _next(u, -2) + _prev(u, -2) + _next(u, -1) + _prev(u, -1)
        py, px = dy - by, dx - bx
        div = (py - _prev(py, -2)) + (px - _prev(px, -1))
        u = (mu * f + lam * (n4 + div)) / den
        # shrinkage (isotropic)
        gy = _next(u, -2) - u + by
        gx = _next(u, -1) - u + bx
        # float32 sqrt, correctly rounded (torch's own float32 sqrt on
        # the CPU is not)
        norm = torch.sqrt(_fma(gx, gx, gy * gy).to(torch.float64)).to(
            torch.float32)
        shrink = (torch.clamp(norm - 1.0 / lam, min=0.0)
                  / torch.clamp(norm, min=1e-12))
        dy, dx = gy * shrink, gx * shrink
        by, bx = _fma(-gy, shrink, gy), _fma(-gx, shrink, gx)
    return u


def denoise_bregman(binary_mask, weight=1.0):
    """Reference ``denoise_bregman`` (``mrc.py:90-108``): TV-denoise the
    float mask and keep pixels > 0.4.  bool (..., H, W) -> bool."""
    return denoise_tv_bregman(binary_mask.to(torch.float32), weight) > 0.4
