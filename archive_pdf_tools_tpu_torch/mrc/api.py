"""High-level MRC decomposition API on torch tensors.

Counterpart of the JAX package's ``mrc/api.py`` (``decompose_masks``,
``decompose_layers``, and the reference API's ``decompose_pages`` and
``create_mrc_hocr_components`` over them), with the semantics of its
Pallas path, which are the reference's (``mrc.py:188-270``): each hOCR
line's crop is thresholded at both polarities and counted whole, the
selected crops are pasted in document order (the last selected line wins
an overlap), then the global threshold is OR-ed in and the mask
despeckled.

The line crops are ragged (``ops/lines_cuda.RaggedLines``), so unlike
the JAX package there are no height buckets, no host patch path for
tall lines and no line capacity that splits a batch.

Batching contract: all pages in one call share (height, width, mode,
dpi-window).  Stage timings use the reference's keys; each stage ends
with a device synchronise so its time is the device's, not the enqueue.
"""

import time as _time

import numpy as np
import torch

from ..const import (
    DENOISE_FAST, DENOISE_NONE, RECODE_RUNTIME_WARNING_TOO_SMALL_TO_DOWNSAMPLE)
from ..ops.lines_cuda import RaggedLines, line_thresholds
from ..ops.paste_cuda import paste_lines
from ..ops.resize import downsample_layer
from ..ops.sauvola import sauvola_window
from ..utils.backend import resolve_device, synchronize
from . import decompose as D
from .hocr_prep import prepare_lines


class TimingData:
    """Reference-compatible (stage, seconds) accumulator."""

    def __init__(self, sink=None):
        self.sink = sink

    def add(self, key, t0):
        if self.sink is not None:
            self.sink.append((key, _time.time() - t0))


def decompose_masks(np_images, word_datas, dpi=None, downsample=None,
                    denoise_mask=DENOISE_FAST, exact_denoise=True,
                    timing_data=None, device=None):
    """Mask phase for a uniform batch.

    np_images: list of uint8 arrays, all (H, W) gray or (H, W, 3) RGB of
    identical shape, or a uint8 (B, H, W[, 3]) tensor; word_datas: the
    hOCR word data of each page (line boxes are divided by
    ``downsample`` when the pages were).  Returns
    (bool (B, H, W) mask, uint8 page tensor), both on ``device``
    (default the first GPU; ``'cpu'`` runs the plain PyTorch versions).

    Timing keys: ``grey_conversion`` (RGB), ``hocr_mask_gen`` (line
    preparation, line thresholds, selection), ``threshold`` (global
    threshold and the ordered paste), ``fast_denoise`` (``denoise`` for
    bregman)."""
    dev = resolve_device(device)
    td = TimingData(timing_data)
    if isinstance(np_images, torch.Tensor):
        imgs = np_images
    else:
        imgs = np.stack(np_images)
    rgb = imgs.ndim == 4
    h, w = imgs.shape[1], imgs.shape[2]
    window = sauvola_window(dpi)

    tl0 = _time.time()
    page_boxes = [prepare_lines(wd, w, h, downsample=downsample)
                  for wd in word_datas]
    prep_dt = _time.time() - tl0

    t0 = _time.time()
    dev_imgs = torch.as_tensor(imgs).to(dev)
    if rgb:
        gray = D.gray_601(dev_imgs)
        synchronize(dev)
        td.add('grey_conversion', t0)
    else:
        gray = dev_imgs

    # the (host) line preparation is folded into this stage, as in the
    # JAX package
    t0 = _time.time() - prep_dt
    lines = RaggedLines.from_page_boxes(page_boxes, h, w, dev)
    if lines.n:
        crops_t, crops_i, counts = line_thresholds(gray, lines, window)
        selector = D.line_selector(crops_t, crops_i, counts, lines)
    td.add('hocr_mask_gen', t0)

    t0 = _time.time()
    mask, _sigma = D.global_mask(gray, window)
    if lines.n:
        mask = paste_lines(crops_t, crops_i, lines, selector, mask)
    synchronize(dev)
    td.add('threshold', t0)

    if denoise_mask is not None and denoise_mask != DENOISE_NONE:
        t0 = _time.time()
        mask = D.denoise_mask(mask, denoise_mask, exact_denoise)
        synchronize(dev)
        td.add('fast_denoise' if denoise_mask == DENOISE_FAST else 'denoise',
               t0)
    return mask, dev_imgs


def decompose_layers(mask, dev_imgs, bg_downsample=None, fg_downsample=None,
                     timing_data=None, errors=None, device=False):
    """fg/bg phase: the radiate fills and the optional layer downsampling,
    as uint8 numpy arrays (downsampled sizes if requested), or with
    ``device=True`` as tensors left on the device, for a device consumer
    (the ``-J tpu`` batch transform).

    mask: bool (B, H, W) tensor; dev_imgs: uint8 (B, H, W[, 3]) tensor on
    the same device.  ``errors`` (a set) collects the reference's
    too-small-to-downsample warning."""
    td = TimingData(timing_data)
    t0 = _time.time()
    fg = D.fg_layer(mask, dev_imgs)
    synchronize(fg.device)
    td.add('fg_partial_blur', t0)
    if fg_downsample:
        t0 = _time.time()
        fg = _downsample(fg, fg_downsample, errors)
        synchronize(fg.device)
        td.add('fg_downsample', t0)

    t0 = _time.time()
    bg = D.bg_layer(mask, dev_imgs)
    synchronize(bg.device)
    td.add('bg_partial_blur', t0)
    if bg_downsample:
        t0 = _time.time()
        bg = _downsample(bg, bg_downsample, errors)
        synchronize(bg.device)
        td.add('bg_downsample', t0)
    if device:
        return fg, bg
    return fg.cpu().numpy(), bg.cpu().numpy()


def _downsample(layer, factor, errors):
    """Layer thumbnail semantics (``mrc.py:420-434``): box (w//f, h//f),
    PIL aspect fit, warning when degenerate."""
    out, ok = downsample_layer(layer, factor)
    if not ok and errors is not None:
        errors.add(RECODE_RUNTIME_WARNING_TOO_SMALL_TO_DOWNSAMPLE)
    return out


def decompose_pages(np_images, word_datas, dpi=None, downsample=None,
                    bg_downsample=None, fg_downsample=None,
                    denoise_mask=DENOISE_FAST, exact_denoise=True,
                    timing_data=None, errors=None, device=None):
    """One-call batched decomposition of a uniform batch: (masks, fgs,
    bgs) as numpy arrays (bool (B, H, W), uint8 layers)."""
    mask, dev_imgs = decompose_masks(
        np_images, word_datas, dpi=dpi, downsample=downsample,
        denoise_mask=denoise_mask, exact_denoise=exact_denoise,
        timing_data=timing_data, device=device)
    fg, bg = decompose_layers(mask, dev_imgs, bg_downsample=bg_downsample,
                              fg_downsample=fg_downsample,
                              timing_data=timing_data, errors=errors)
    return mask.cpu().numpy(), fg, bg


def create_mrc_hocr_components(image, hocr_word_data, dpi=None,
                               downsample=None, bg_downsample=None,
                               fg_downsample=None, denoise_mask=None,
                               timing_data=None, errors=None,
                               exact_denoise=True, device=None):
    """Generator equivalent of the reference API (``mrc.py:334``): yields
    the mask, then the foreground, then the background, as numpy arrays,
    for one PIL image page.  ``denoise_mask=None`` is no despeckle, as
    in the reference."""
    if image.mode not in ('L', 'RGB'):
        t0 = _time.time()
        image = image.convert('RGB')
        if timing_data is not None:
            timing_data.append(('grey_conversion', _time.time() - t0))

    mask, dev_imgs = decompose_masks(
        [np.asarray(image)], [hocr_word_data], dpi=dpi,
        downsample=downsample, denoise_mask=denoise_mask or DENOISE_NONE,
        exact_denoise=exact_denoise, timing_data=timing_data, device=device)

    yield mask[0].cpu().numpy()

    fg, bg = decompose_layers(mask, dev_imgs, bg_downsample=bg_downsample,
                              fg_downsample=fg_downsample,
                              timing_data=timing_data, errors=errors)
    yield fg[0]
    yield bg[0]
