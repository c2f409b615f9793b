"""``--denoise-mask fast``: the despeckle of the port's K2
(``ops/denoise.py``, the plain version of ``csrc/despeckle.cu``), a
frozen copy.  Integer work: ``ftype`` is not used."""

import torch

from .mrc import box_sum_2d, sliding_sum

MINCNT = 4
N = 2


def denoise(mask, ftype=torch.float32, mincnt=MINCNT, n=N):
    """Sequential despeckle: in row-major order a set interior pixel
    survives iff its (2n+1)^2 window in the partly updated mask holds at
    least ``mincnt`` other set pixels.  Rows are a loop; within a row the
    dependence on the last n produced bits is a 2^n-state machine
    evaluated by a prefix scan of transition maps."""
    nstates = 1 << n
    b, h, w = mask.shape
    dev = mask.device
    mi = mask.to(torch.int64)
    bot = box_sum_2d(mi, (1, n + 1), (-n, n + 1))
    cur = sliding_sum(mi, 1, n + 1, -1)
    cols = torch.arange(w, device=dev)
    col_border = (cols < n) | (cols >= w - n)
    states = torch.arange(nstates, device=dev)
    pc = torch.tensor([bin(s).count('1') for s in range(nstates)], device=dev)
    shifted = (states << 1) & (nstates - 1)
    out = torch.empty_like(mi)
    colsum = torch.zeros((b, w), dtype=torch.int64, device=dev)
    for y in range(h):
        m_row = mi[:, y]
        top = sliding_sum(colsum, -n, n + 1, -1)
        tau = mincnt - top - bot[:, y] - cur[:, y]
        forced = (m_row == 0) | col_border | (y < n) | (y >= h - n)
        bit = torch.where(forced[..., None], m_row[..., None],
                          (pc >= tau[..., None]).to(torch.int64))
        maps = shifted | bit
        d = 1
        while d < w:
            maps = torch.cat([maps[:, :d],
                              maps[:, d:].gather(2, maps[:, :-d])], dim=1)
            d *= 2
        row = maps[..., 0] & 1
        out[:, y] = row
        colsum += row
        if y >= n:
            colsum -= out[:, y - n]
    return out.to(torch.bool)
