"""Special RGB->gray conversion (``--grayscale-pdf``), counterpart of the
JAX package's ``ops/grayconvert.py`` (reference ``grayconvert.py``, a
port of IA's color2Gray.sh).

Each channel is level-stretched between thresholds that come from the
whole channel's statistics (min, max, mean, standard deviation); the
result is the HSL lightness of the stretched pixel.

The statistics decide integer thresholds through floors, so their
rounding matters.  The JAX package takes them as float32 reductions of
``img / 255``, whose summation order differs between XLA, torch's CPU
and the card.  Here they come from a per-page, per-channel histogram
(exact int64 counts, on the pages' device), brought to the host (3 x 256
counts a page) and reduced there in one fixed order: every per-pixel
float32 step of the JAX function (``px / 255``, ``x - mean``, its
square) is taken per histogram bin in float32, and only the sums over
the bins run in float64.  The thresholds, and so the output, are then
the same on the card and on the CPU bit for bit.  The stretch and the
lightness are exact integer arithmetic on the device.
"""

import torch


def _level(px, low, high):
    """``level_arr`` (reference ``grayconvert.py:24-31``) in exact integer
    arithmetic: the stretched value is the rational
    (100*px - 255*low) / (high - low), truncated by a floor division.
    px: int32 (B, H, W); low, high: int32 (B, 1, 1)."""
    out = (100 * px - 255 * low) // torch.clamp(high - low, min=1)
    out = torch.where(20 * px < 51 * low, 0, out)      # px < minv
    out = torch.where(20 * px > 51 * high, 255, out)   # px > maxv
    return out.clamp(0, 255)


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _channel_stats(hist):
    """(min, max, mean, std) float32 of ``img / 255`` per page and
    channel from int64 histograms (B, 3, 256) on the host, in the JAX
    function's per-element float32 steps."""
    vals = torch.arange(256, dtype=torch.float32) / 255.0      # px / 255
    n = hist.sum(-1).to(torch.float64)                        # (B, 3)
    seen = hist > 0
    idx = torch.arange(256)
    lo = torch.where(seen, idx, 256).amin(-1)
    hi = torch.where(seen, idx, -1).amax(-1)
    mn, mx = vals[lo], vals[hi]
    mean = _f32((hist.to(torch.float64) * vals.to(torch.float64)).sum(-1)
                / n)
    dev = vals - mean[..., None]                               # float32
    var = _f32((hist.to(torch.float64) * (dev * dev).to(torch.float64))
               .sum(-1) / n)
    return mn, mx, mean, torch.sqrt(var)


def special_gray_convert(img):
    """img: uint8 (B, H, W, 3) on any device -> uint8 (B, H, W) there."""
    if img.dtype != torch.uint8 or img.dim() != 4 or img.shape[-1] != 3:
        raise TypeError('special_gray_convert: need uint8 (B, H, W, 3), '
                        'got %s %s' % (img.dtype, tuple(img.shape)))
    b = img.shape[0]
    dev = img.device
    # bin of each sample: (page, channel, value)
    base = (torch.arange(b, device=dev)[:, None, None, None] * 3
            + torch.arange(3, device=dev)) * 256
    hist = torch.bincount((img.to(torch.int64) + base).reshape(-1),
                          minlength=b * 3 * 256).reshape(b, 3, 256).cpu()
    mn, mx, mean, std = _channel_stats(hist)

    # the JAX function's float32 steps, in its order
    r_mean, g_mean, b_mean = mean.unbind(-1)
    r_std, g_std, b_std = std.unbind(-1)
    bright = (r_mean * g_mean * b_mean
              / (mx[:, 2] * (1 - r_std) * (1 - g_std) * (1 - b_std)))
    bright = torch.round(bright * 1e4) / 1e4                  # round(x, 4)
    low = torch.clamp(torch.floor(196.0 * mn[:, 0] + 14.5), max=50.0)
    highs = [torch.clamp(torch.floor(a * bright + c), max=95.0)
             for a, c in ((35.66, 48.5), (39.22, 44.5), (45.16, 36.5))]
    levels = torch.stack([low] + highs, -1).to(torch.int32).to(dev)

    low = levels[:, 0, None, None]
    px = img.to(torch.int32)
    out = [_level(px[..., c], low, levels[:, 1 + c, None, None])
           for c in range(3)]
    # HSL 'L' of the stretched pixel: with S = (V - mn) / V and
    # L = V * (1 - S/2) it is exactly (V + mn) / 2 on the 0..255 scale
    v = torch.maximum(torch.maximum(out[0], out[1]), out[2])
    m = torch.minimum(torch.minimum(out[0], out[1]), out[2])
    return ((v + m) // 2).to(torch.uint8)
