"""``--denoise-mask bregman``: upstream's ``denoise_bregman``
(``internetarchivepdf/mrc.py:90-108``): total-variation denoise of the
float mask by split Bregman with weight 1.0, pixels > 0.4 kept.

Written from the algorithm (Goldstein and Osher, "The split Bregman
method for L1-regularized problems", 2009), isotropic, with skimage's
parameters: the split penalty lambda = 2w and the fidelity mu = w.  Each
iteration:

    u   = (mu f + lambda (sum of u's 4 neighbours + div(d - b)))
          / (mu + 4 lambda)                      one Jacobi step
    g   = grad u + b                             forward differences
    d   = g * max(|g| - 1/lambda, 0) / |g|       isotropic shrinkage
    b   = g - d                                  the Bregman update

with the image's edge pixel repeated outside it, so that a difference
reaching past an edge is 0.  It departs from skimage's
``denoise_tv_bregman`` as the configuration states: 100 Jacobi
iterations, every pixel from the last iterate, where skimage runs
Gauss-Seidel sweeps until its tolerance (or 100 sweeps) stops them; and
float32 throughout, where skimage computes in float64.

Precision (``configs/bw_bregman.json``), since an iterate amplifies a
one-ulp difference to tenths within 100 steps: every operation one
float32 rounding, in the order written above, the 4-neighbour sum as
((below + above) + right) + left and the divergence as
(py - py_above) + (px - px_left); the two contractions ``|g|^2 =
gx * gx + (gy * gy)`` and ``b = g - g * shrink`` each rounded once, as
a fused multiply-add; the square root and both divisions correctly
rounded, the divisor ``mu + 4 lambda`` held on the mask's device.

Here the fused multiply-add is an exact float64 product, a float64 sum
``s`` with its error ``e`` (Knuth's two-sum), and ``s`` rounded to
float32, nudged to the neighbour on ``e``'s side where ``s`` lies on a
float32 rounding midpoint (the one case in which rounding twice differs
from rounding once).  The square root is float64's of the float32
value, rounded to float32.  With ``ftype`` lower than float32 (the
control) every product, sum, root and quotient rounds in ``ftype``.
Nothing here imports the port.
"""

import torch

WEIGHT = 1.0
ITERATIONS = 100
THRESHOLD = 0.4


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once."""
    p = a.to(torch.float64) * b.to(torch.float64)     # exact: 24 x 24 bits
    c = c.to(torch.float64)
    s = p + c
    z = s - p
    e = (p - (s - z)) + (c - z)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    up = torch.full_like(r, torch.inf)
    other = torch.nextafter(r, torch.where(s > r64, up, -up))
    on_midpoint = (r64 + other.to(torch.float64)) * 0.5 == s
    side = torch.where(e > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(on_midpoint & (e != 0), side, r)


def _fma(a, b, c, ftype):
    if ftype == torch.float32:
        return fma32(a, b, c)
    return a * b + c


def _sqrt(x, ftype):
    if ftype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _shifted(x, dim, step):
    """x[i + step] along ``dim``, the edge's value repeated past it."""
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(n, device=x.device) + step, 0, n - 1)
    return x.index_select(dim, idx)


def tv_bregman(f, ftype=torch.float32):
    """The TV-denoised image of f (..., H, W) in ``ftype``."""
    f = f.to(ftype)
    lam, mu = 2.0 * WEIGHT, WEIGHT
    den = torch.tensor(mu + 4.0 * lam, dtype=ftype, device=f.device)
    u = f
    dy, dx, by, bx = (torch.zeros_like(f) for _ in range(4))
    for _ in range(ITERATIONS):
        n4 = _shifted(u, -2, 1) + _shifted(u, -2, -1)
        n4 = (n4 + _shifted(u, -1, 1)) + _shifted(u, -1, -1)
        py, px = dy - by, dx - bx
        div = (py - _shifted(py, -2, -1)) + (px - _shifted(px, -1, -1))
        u = (mu * f + lam * (n4 + div)) / den
        gy = (_shifted(u, -2, 1) - u) + by
        gx = (_shifted(u, -1, 1) - u) + bx
        norm = _sqrt(_fma(gx, gx, gy * gy, ftype), ftype)
        shrink = torch.clamp(norm - 1.0 / lam, min=0.0) \
            / torch.clamp(norm, min=1e-12)
        dy, dx = gy * shrink, gx * shrink
        by, bx = _fma(-gy, shrink, gy, ftype), _fma(-gx, shrink, gx, ftype)
    return u


def denoise(mask, ftype=torch.float32):
    """bool (..., H, W) -> bool (..., H, W): pixels of the TV-denoised float
    mask above 0.4."""
    return tv_bregman(mask.to(ftype), ftype) > THRESHOLD
