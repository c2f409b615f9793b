"""Batched MRC decomposition stages (mask -> fg -> bg) on torch tensors.

Counterpart of the JAX package's ``mrc/decompose.py``: gray conversion,
the noise estimate and its blur taps, the global threshold (pre-blur +
Sauvola, k=0.34), the host line-selection heuristic and the mask
despeckle (exact, one-pass or TV); the fg/bg radiate fills are
``ops/optimise_cuda.optimise`` (n=3 on the mask, n=10 on its inverse,
``mrc.py:408-449``).  Each kernel stage calls a wrapper that runs the
hand-written CUDA kernel for a CUDA tensor and the plain PyTorch version
for a CPU tensor.
"""

import numpy as np
import torch

from ..const import DENOISE_BREGMAN, DENOISE_FAST
from ..ops.sigma_np import estimate_sigma_np
from ..ops.threshold_cuda import MAX_BLUR_RADIUS, RADIUS_BUCKETS
from ..ops.denoise import fast_mask_denoise_jacobi
from ..ops.denoise_cuda import fast_mask_denoise
from ..ops.tv import denoise_bregman


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


def blur_taps(sigma_ests, radius=None):
    """Host taps for the noise estimates of a batch's page shards, each
    in the smallest radius bucket covering the whole batch (or in
    ``radius``): one device-to-host read, and the taps made for the
    batch at once, so a shard's rows round as the whole batch's do.
    -> a list of CPU f32 (pages, 2R+1), one a shard."""
    sig = torch.cat([s.cpu() for s in sigma_ests])
    if radius is None:
        radius = pick_blur_radius(sig)
    taps = blur_weights_from_sigma(sig, radius)
    return list(taps.split([len(s) for s in sigma_ests]))


def from_jax_state(taps_np, window, device):
    """The only state that crosses from the JAX package: the per-page blur
    taps (numpy f32 (B, 2R+1), e.g. from its ``blur_weights``) and the
    Sauvola window -> (taps tensor on ``device``, window)."""
    taps = torch.as_tensor(np.asarray(taps_np, np.float32), device=device)
    return taps.contiguous(), int(window)


def select_lines(ones, ones_inv, size, sigma_fn, n_lines):
    """Host-side selection heuristic per line (``mrc.py:231-264``).

    sigma_fn(line_idx) -> (ratio_sigma, inv_ratio_sigma) is only invoked
    for lines the ratio tests cannot decide (it is expensive; the
    reference guards it the same way).

    Returns boolean numpy arrays (use_plain, use_inv) indexed by line id.
    """
    n_seg = len(size)
    use_plain = np.zeros(n_seg, bool)
    use_inv = np.zeros(n_seg, bool)
    for i in range(1, n_lines + 1):
        sz = int(size[i])
        if sz <= 0:
            continue
        ratio = int(ones[i]) / sz
        inv_ratio = int(ones_inv[i]) / sz
        if ratio < 0.3 or inv_ratio < 0.3:
            if inv_ratio > 0.2 and ratio < 0.2:
                use_plain[i] = True
            else:
                ratio_sigma, inv_ratio_sigma = sigma_fn(i)
                if inv_ratio < 0.3 and inv_ratio < ratio and \
                        (inv_ratio_sigma < ratio_sigma or
                         (ratio_sigma < 0.1 and inv_ratio_sigma < 0.1)):
                    use_inv[i] = True
                elif ratio < 0.2:
                    use_plain[i] = True
    return use_plain, use_inv


def fetch_crops(crops_t, crops_i, lines, idx):
    """Crops of the lines ``idx`` at both polarities, gathered from the
    ragged buffers on their device and brought to the host in ONE copy.
    Returns {line: (crop_t, crop_i)} of uint8 numpy (b-t, r-l) arrays."""
    idx = np.asarray(idx, np.int64)
    if len(idx) == 0:
        return {}
    dev = crops_t.device
    lens = lines.sizes[idx]
    total = int(lens.sum())
    starts = torch.from_numpy(lines.offsets[idx]).to(dev)
    firsts = torch.from_numpy(np.cumsum(lens) - lens).to(dev)
    lens_t = torch.from_numpy(lens).to(dev)
    pos = (torch.repeat_interleave(starts - firsts, lens_t,
                                   output_size=total)
           + torch.arange(total, device=dev))
    both = torch.stack([crops_t[pos], crops_i[pos]]).cpu().numpy()
    out = {}
    a = 0
    for i, n in zip(idx, lens):
        t, b, l, r = lines.boxes[i]
        shape = (int(b - t), int(r - l))
        out[int(i)] = (both[0, a:a + n].reshape(shape),
                       both[1, a:a + n].reshape(shape))
        a += n
    return out


def line_selector(crops_t, crops_i, counts, lines):
    """Which crop each line pastes: host int32 (n,) of 0 (none), 1
    (plain) or 2 (inverse), by ``select_lines`` on the ink counts.  The
    lines whose ratios cannot decide (``mrc.py:240-251``) need the
    wavelet sigma of both crops: those crops are fetched together, in
    one device-to-host copy, before the heuristic runs."""
    n = lines.n
    cnt = counts.cpu().numpy().astype(np.int64)
    # slot 0 is a dummy line (select_lines counts lines from 1)
    ones = np.concatenate([[0], cnt[:, 0]])
    ones_inv = np.concatenate([[0], cnt[:, 1]])
    size = np.concatenate([[0], lines.sizes]).astype(np.int64)
    size_h = np.maximum(size, 1)
    ratio = ones / size_h
    inv = ones_inv / size_h
    needy = np.flatnonzero(((ratio < 0.3) | (inv < 0.3))
                           & ~((inv > 0.2) & (ratio < 0.2))
                           & (np.arange(n + 1) > 0))
    cache = fetch_crops(crops_t, crops_i, lines, needy - 1)

    def sigma_fn(i):
        ct, ci = cache[i - 1]
        return (estimate_sigma_np(ct.astype(np.float64)),
                estimate_sigma_np(ci.astype(np.float64)))

    use_plain, use_inv = select_lines(ones, ones_inv, size, sigma_fn, n)
    return np.where(use_plain, 1, np.where(use_inv, 2, 0))[1:] \
        .astype(np.int32)


def denoise_mask(mask, mode, exact=True):
    """Mask despeckle dispatch (``mrc.py:384-396``): fast is the exact
    despeckle kernel, or with ``exact=False`` the one-pass approximation;
    bregman the TV denoise; anything else keeps the mask."""
    if mode == DENOISE_FAST:
        if not exact:
            return fast_mask_denoise_jacobi(mask, 4, 2)
        return fast_mask_denoise(mask, 4, 2)
    if mode == DENOISE_BREGMAN:
        return denoise_bregman(mask)
    return mask
