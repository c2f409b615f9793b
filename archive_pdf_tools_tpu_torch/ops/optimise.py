"""fg/bg 'optimise' radiate fill, plain PyTorch and exact (counterpart of
the JAX package's ``ops/optimise.py``; reference
``optimiser.pyx:153-429``).

For every non-mask pixel

    out[y,x] = (FIR_sum + IIR_sum) // (FIR_cnt + IIR_cnt)    (0 if cnt==0)

    FIR: sum/count of img over mask pixels in the clamped window
         rows [y-n, y+n) x cols [x-n, x+n)
    IIR: sum of already-produced output over rows [y-n, y) x cols
         [x-n, x), counted as min(y,n)*(x-max(x-n,0)) pixels
         irrespective of the mask

and mask pixels pass img through.  The IIR term never reads the current
row, so the fill is an exact row recurrence: a Python loop over rows,
each step vectorised over (batch, channels, width).  Every quantity is
a non-negative integer, so integer floor division is the reference's C
division.  This is the CPU path and the oracle of ``csrc/optimise.cu``.
"""

import torch

from .window import box_sum_2d


def optimise(mask, img, n_size):
    """mask: bool (B, H, W); img: uint8 (B, H, W) or (B, H, W, C).
    Returns uint8 of img's shape."""
    gray = img.dim() == 3
    if gray:
        img = img[..., None]
    b, h, w, c = img.shape
    n = int(n_size)
    dev = img.device

    mi = mask.to(torch.int64)[:, None]                 # (B, 1, H, W)
    xi = img.to(torch.int64).permute(0, 3, 1, 2)       # (B, C, H, W)
    fir_val = box_sum_2d(xi * mi, (-n, n), (-n, n))
    fir_cnt = box_sum_2d(mi, (-n, n), (-n, n))

    cols = torch.arange(w, device=dev)
    xs_idx = (cols - n).clamp(min=0)
    iir_w = cols - xs_idx

    out = torch.empty_like(xi)
    colsum = torch.zeros((b, c, w), dtype=torch.int64, device=dev)
    zero = torch.zeros((b, c, 1), dtype=torch.int64, device=dev)
    for y in range(h):
        pref = torch.cat([zero, torch.cumsum(colsum, dim=-1)], dim=-1)
        iir_sum = pref[..., :w] - pref[..., xs_idx]     # cols [xs, x)
        cnt = fir_cnt[:, :, y] + min(y, n) * iir_w
        val = fir_val[:, :, y] + iir_sum
        filled = torch.where(cnt > 0, val // cnt.clamp(min=1), 0)
        row = torch.where(mask[:, None, y], xi[:, :, y], filled)
        out[:, :, y] = row
        colsum += row
        if y >= n:
            colsum -= out[:, :, y - n]
    out = out.permute(0, 2, 3, 1).to(torch.uint8)
    return out[..., 0] if gray else out
