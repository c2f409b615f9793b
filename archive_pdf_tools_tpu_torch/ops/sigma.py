"""Wavelet-MAD noise estimate (skimage ``estimate_sigma`` semantics),
plain PyTorch counterpart of the JAX package's ``ops/sigma.py``.

A single-level db2 transform with pywt's exact conventions (half-sample
symmetric extension, pad (F-2, F-1), stride-2 windows of the reversed
filter, output length ``(n + F - 1) // 2``), the diagonal detail band,
exact zeros dropped, and ``median(|dd|) / Phi^-1(0.75)`` where the
median is the mean of the ``(n-1)//2``-th and ``n//2``-th order
statistics.  Runs on the tensor's device; the filter taps are applied
as explicit float32 multiply-adds (no convolution library, so no TF32).
"""

import numpy as np
import torch

# Daubechies-2 decomposition high-pass filter (pywt 'db2')
_DB2_HI = np.array([-0.48296291314469025, 0.836516303737469,
                    -0.22414386804185735, -0.12940952255092145], np.float32)

_MAD_DENOM = 0.6744897501960817  # scipy.stats.norm.ppf(0.75)


def symmetric_index(n, lo, hi, device):
    """Source indices of ``np.pad(..., (lo, hi), mode='symmetric')`` on an
    axis of length n (edge-repeating reflection, repeated when the pad
    is longer than the axis)."""
    p = torch.arange(-lo, n + hi, device=device) % (2 * n)
    return torch.where(p < n, p, 2 * n - 1 - p)


def _dwt1d(x, filt, dim):
    """Single-level 1-D DWT pass along dim, pywt-exact, float32."""
    x = x.movedim(dim, -1)
    k = len(filt)
    n = x.shape[-1]
    xp = x[..., symmetric_index(n, k - 2, k - 1, x.device)]
    nout = (n + k - 1) // 2
    kern = filt[::-1]
    out = None
    for j in range(k):
        term = float(kern[j]) * xp[..., j:j + 2 * nout - 1:2]
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def diagonal_detail(img):
    """Diagonal (HH) subband of a single-level db2 DWT, trailing two dims."""
    d = _dwt1d(img.to(torch.float32), _DB2_HI, dim=-2)
    return _dwt1d(d, _DB2_HI, dim=-1)


def _masked_median(flat, keep):
    """Median of each row of (B, N) over entries where keep; 0 when none."""
    n = keep.sum(dim=1)
    keys = torch.where(keep, flat, torch.full_like(flat, float('inf')))
    srt = torch.sort(keys, dim=1).values
    lo_i = ((n - 1) // 2).clamp(min=0)
    hi_i = (n // 2).clamp(min=0)
    lo = srt.gather(1, lo_i[:, None])[:, 0]
    hi = srt.gather(1, hi_i[:, None])[:, 0]
    return torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(lo))


def estimate_sigma(img):
    """MAD noise sigma per page of a (B, H, W) batch -> f32 (B,)."""
    dd = diagonal_detail(img)
    flat = dd.reshape(dd.shape[0], -1).abs()
    med = _masked_median(flat, flat > 0)
    return med / torch.tensor(_MAD_DENOM, dtype=torch.float32,
                              device=med.device)


def estimate_noise(img):
    """Centre-crop sigma estimate (``mrc.py:273-296``): crop to the middle
    half in each dim (h/2 +- h/4, w/2 +- w/4); tiny images use the
    full frame."""
    h, w = img.shape[-2], img.shape[-1]
    mul = 4
    hs, he = int(h / 2 - h / mul), int(h / 2 + h / mul)
    ws, we = int(w / 2 - w / mul), int(w / 2 + w / mul)
    if he == 0 or we == 0:
        hs, he, ws, we = 0, h, 0, w
    return estimate_sigma(img[..., hs:he, ws:we])
