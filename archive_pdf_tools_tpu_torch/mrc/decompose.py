"""Batched MRC decomposition stages (mask -> fg -> bg) on torch tensors.

Counterpart of the JAX package's ``mrc/decompose.py`` for pages with no
hOCR lines: gray conversion, the noise estimate and its blur taps, the
global threshold (pre-blur + Sauvola, k=0.34), the mask despeckle and
the fg/bg radiate fills.  Each kernel stage calls a wrapper that runs
the hand-written CUDA kernel for a CUDA tensor and the plain PyTorch
version for a CPU tensor.
"""

import numpy as np
import torch

from archive_pdf_tools_tpu.const import DENOISE_FAST, DENOISE_NONE

from ..ops.sigma import estimate_noise
from ..ops.threshold_cuda import (MAX_BLUR_RADIUS, RADIUS_BUCKETS,
                                  blur_sauvola)
from ..ops.denoise_cuda import fast_mask_denoise
from ..ops.optimise_cuda import optimise


def gray_601(img_rgb):
    """PIL Image.convert('L') exact semantics: ITU-R 601-2 luma in 16.16
    fixed point with rounding: (R*19595 + G*38470 + B*7471 + 2^15) >> 16."""
    x = img_rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return ((r * 19595 + g * 38470 + b * 7471 + 32768) >> 16).to(torch.uint8)


def blur_weights_from_sigma(sigma_est, max_radius=MAX_BLUR_RADIUS):
    """Per-page separable gaussian taps (``mrc.py:305-311``): scipy's
    sampled kernel truncated at radius int(4*sigma+0.5) inside a static
    max_radius buffer, normalised; the identity kernel when the
    reference would skip the blur (sigma_est <= 1).  -> f32 (B, 2R+1)."""
    dev = sigma_est.device
    sigma = sigma_est * 0.1
    idx = torch.arange(-max_radius, max_radius + 1, dtype=torch.float32,
                       device=dev)
    radius = torch.floor(4.0 * sigma + 0.5)[:, None]
    sig2 = sigma.clamp(min=1e-6)[:, None] ** 2
    wts = torch.exp(-0.5 * idx[None, :] ** 2 / sig2)
    wts = torch.where(idx[None, :].abs() <= radius, wts, 0.0)
    wts = wts / wts.sum(dim=1, keepdim=True)
    ident = (idx == 0).to(torch.float32)
    return torch.where((sigma_est > 1.0)[:, None], wts, ident[None, :])


def pick_blur_radius(sigma_est):
    """Host-side: smallest static radius bucket covering the batch's
    per-page scipy blur radius int(4 * 0.1*sigma_est + 0.5)."""
    sig = sigma_est.detach().cpu().numpy().astype(np.float32)
    need = int(np.floor(4.0 * 0.1 * sig.max() + 0.5))
    return next((r for r in RADIUS_BUCKETS if need <= r),
                RADIUS_BUCKETS[-1])


def from_jax_state(taps_np, window, device):
    """The only state that crosses from the JAX package: the per-page blur
    taps (numpy f32 (B, 2R+1), e.g. from its ``blur_weights``) and the
    Sauvola window -> (taps tensor on ``device``, window)."""
    taps = torch.as_tensor(np.asarray(taps_np, np.float32), device=device)
    return taps.contiguous(), int(window)


def global_mask(gray, window, taps=None):
    """Pre-blur + global Sauvola through the blur+Sauvola kernel, with
    taps in the smallest radius bucket covering the batch, or the given
    ``taps`` (e.g. from ``from_jax_state``).
    -> (bool mask, sigma_est or None)."""
    if taps is not None:
        return blur_sauvola(gray, taps, window), None
    sigma_est = estimate_noise(gray)
    taps = blur_weights_from_sigma(sigma_est, pick_blur_radius(sigma_est))
    return blur_sauvola(gray, taps.contiguous(), window), sigma_est


def denoise_mask(mask, mode, exact=True):
    """Mask despeckle dispatch (``mrc.py:384-396``)."""
    if mode is None or mode == DENOISE_NONE:
        return mask
    if mode != DENOISE_FAST:
        raise NotImplementedError('--denoise-mask %s is not ported; use '
                                  'fast or none' % mode)
    if not exact:
        raise NotImplementedError('--approx-denoise is not ported')
    return fast_mask_denoise(mask, 4, 2)


def fg_layer(mask, img):
    """Foreground radiate fill, n=3 (``mrc.py:408-415``)."""
    return optimise(mask, img, 3)


def bg_layer(mask, img):
    """Background radiate fill with inverted mask, n=10
    (``mrc.py:439-449``)."""
    return optimise(~mask, img, 10)
