"""Mask despeckle, plain PyTorch (counterpart of the JAX package's
``ops/denoise.py``: ``fast_mask_denoise_exact`` and
``fast_mask_denoise_jacobi``; reference ``optimiser.pyx:436-472``).

Scanning the interior in row-major order, a set pixel survives iff its
(2n+1)^2 neighbourhood in the *partly updated* mask holds at least
``mincnt`` other set pixels.  Per pixel that count splits into

    TOP (final rows y-n..y-1) + BOT (original rows y+1..y+n)
    + CUR (original row y, cols x+1..x+n)
    + popcount(last n produced bits of this row),

so within a row the only recurrence runs through the last n produced
bits: a 2^n-state machine.  Each pixel becomes a transition map (next
state for every current state); an inclusive Hillis-Steele scan of map
compositions (``torch.gather``) applied to the start state 0 gives the
exact sequential result.  Rows are an outer Python loop.  Border rows
and columns (< n, >= h-n / w-n) and zero pixels keep their value.  This
is the CPU path and the oracle of ``csrc/despeckle.cu``.

``fast_mask_denoise_jacobi`` (``--approx-denoise``) is the one-pass
approximation: the neighbourhood counts of the unmodified mask, exact
integer window sums on the tensor's device (torch ops on the card too).
"""

import torch

from .window import box_sum_2d, sliding_sum


def fast_mask_denoise_exact(mask, mincnt=4, n_size=2):
    """Bit-exact sequential despeckle. mask: bool (B, H, W), 1 <= n <= 3."""
    n = int(n_size)
    if not 1 <= n <= 3:
        raise ValueError('n_size must be 1..3, got %d' % n)
    nstates = 1 << n
    b, h, w = mask.shape
    dev = mask.device
    mi = mask.to(torch.int64)

    bot = box_sum_2d(mi, (1, n + 1), (-n, n + 1))        # rows below
    cur = sliding_sum(mi, 1, n + 1, dim=-1)              # right of self
    cols = torch.arange(w, device=dev)
    col_border = (cols < n) | (cols >= w - n)
    states = torch.arange(nstates, device=dev)
    pc = torch.tensor([bin(s).count('1') for s in range(nstates)],
                      device=dev)
    shifted = (states << 1) & (nstates - 1)              # next, less new bit

    out = torch.empty_like(mi)
    colsum = torch.zeros((b, w), dtype=torch.int64, device=dev)
    for y in range(h):
        m_row = mi[:, y]
        top = sliding_sum(colsum, -n, n + 1, dim=-1)     # final rows
        tau = mincnt - top - bot[:, y] - cur[:, y]       # keep iff pc >= tau
        forced = (m_row == 0) | col_border | (y < n) | (y >= h - n)
        bit = torch.where(forced[..., None], m_row[..., None],
                          (pc >= tau[..., None]).to(torch.int64))
        maps = shifted | bit                             # (B, W, S)
        d = 1
        while d < w:     # maps[x] := maps[x] o maps[x-d]
            maps = torch.cat([maps[:, :d],
                              maps[:, d:].gather(2, maps[:, :-d])], dim=1)
            d *= 2
        row = maps[..., 0] & 1                           # from state 0
        out[:, y] = row
        colsum += row
        if y >= n:
            colsum -= out[:, y - n]
    return out.to(torch.bool)


def fast_mask_denoise_jacobi(mask, mincnt=4, n_size=2):
    """One-pass despeckle on the original neighbourhood counts: a set
    pixel survives iff its (2n+1)^2 window holds at least ``mincnt``
    other set pixels; pixels within n of an edge keep their value.
    mask: bool (B, H, W) -> bool."""
    n = int(n_size)
    h, w = mask.shape[-2], mask.shape[-1]
    cnt = box_sum_2d(mask.to(torch.int32), (-n, n + 1), (-n, n + 1)) - 1
    rows = torch.arange(h, device=mask.device)[:, None]
    cols = torch.arange(w, device=mask.device)
    interior = ((rows >= n) & (rows < h - n)) & ((cols >= n) & (cols < w - n))
    return mask & (~interior | (cnt >= mincnt))
