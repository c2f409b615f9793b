"""Exact clamped sliding-window sums (counterpart of the JAX package's
``ops/window.py``).

Integer inputs are summed with ``torch.cumsum``, which accumulates
integer tensors in int64, so every window sum is exact.  Functions act
on one dimension (or the trailing two) and broadcast over the rest.
"""

import torch


def sliding_sum(x, lo_off, hi_off, dim):
    """out[i] = sum(x[max(i+lo_off, 0) : min(i+hi_off, n)]) along dim."""
    dim = dim % x.dim()
    n = x.shape[dim]
    cs = torch.cumsum(x, dim=dim)
    zshape = list(cs.shape)
    zshape[dim] = 1
    cs = torch.cat([torch.zeros(zshape, dtype=cs.dtype, device=cs.device),
                    cs], dim=dim)                  # cs[k] = sum of first k
    i = torch.arange(n, device=x.device)
    lo = (i + lo_off).clamp(0, n)
    hi = (i + hi_off).clamp(0, n)
    return cs.index_select(dim, hi) - cs.index_select(dim, lo)


def box_sum_2d(x, row_off, col_off):
    """Exact clamped 2-D window sum over the last two dims; row_off and
    col_off are (lo, hi) offsets of the half-open window [i+lo, i+hi)."""
    s = sliding_sum(x, row_off[0], row_off[1], dim=-2)
    return sliding_sum(s, col_off[0], col_off[1], dim=-1)
