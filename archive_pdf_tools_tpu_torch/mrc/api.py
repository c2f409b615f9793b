"""High-level MRC decomposition API on torch tensors.

Counterpart of the JAX package's ``mrc/api.py`` for batches whose pages
hold no hOCR text lines (the ``total == 0`` branch of its
``decompose_masks``): the mask is the global threshold, despeckled.  A
batch with any hOCR line raises ``NotImplementedError``: the line
threshold and paste kernels are not ported yet, and a global-only mask
would be a different result.

Batching contract: all pages in one call share (height, width, mode,
dpi-window).  Stage timings use the reference's keys; each stage ends
with a device synchronise so its time is the device's, not the enqueue.
"""

import time as _time

import numpy as np
import torch

from archive_pdf_tools_tpu.const import DENOISE_FAST, DENOISE_NONE
from archive_pdf_tools_tpu.mrc.hocr_prep import prepare_lines

from ..ops.sauvola import sauvola_window
from ..utils.backend import resolve_device, synchronize
from . import decompose as D


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
    """Mask phase for a uniform batch of pages with no hOCR lines.

    np_images: list of uint8 arrays, all (H, W) gray or (H, W, 3) RGB of
    identical shape.  Returns (bool (B, H, W) mask, uint8 page tensor),
    both on ``device`` (default the first GPU; ``'cpu'`` runs the plain
    PyTorch versions)."""
    if downsample:
        raise NotImplementedError('--downsample is not ported')
    dev = resolve_device(device)
    td = TimingData(timing_data)
    imgs = np.stack(np_images)
    rgb = imgs.ndim == 4
    h, w = imgs.shape[1], imgs.shape[2]
    window = sauvola_window(dpi)

    tl0 = _time.time()
    page_boxes = [prepare_lines(wd, w, h) for wd in word_datas]
    prep_dt = _time.time() - tl0
    for p, boxes in enumerate(page_boxes):
        if boxes:
            raise NotImplementedError(
                'page %d of the batch has %d hOCR line(s), the first at '
                '(top, bottom, left, right) = %s: the line-threshold and '
                'paste kernels are not ported yet'
                % (p, len(boxes), boxes[0]))

    t0 = _time.time()
    dev_imgs = torch.from_numpy(imgs).to(dev)
    if rgb:
        gray = D.gray_601(dev_imgs)
        synchronize(dev)
        td.add('grey_conversion', t0)
    else:
        gray = dev_imgs
    # no lines: the (host) line preparation is this stage's whole cost
    td.add('hocr_mask_gen', _time.time() - prep_dt)

    t0 = _time.time()
    mask, _sigma = D.global_mask(gray, window)
    synchronize(dev)
    td.add('threshold', t0)

    if denoise_mask is not None and denoise_mask != DENOISE_NONE:
        t0 = _time.time()
        mask = D.denoise_mask(mask, denoise_mask, exact_denoise)
        synchronize(dev)
        td.add('fast_denoise', t0)
    return mask, dev_imgs


def decompose_layers(mask, dev_imgs, bg_downsample=None, fg_downsample=None,
                     timing_data=None):
    """fg/bg phase: the radiate fills, as uint8 numpy arrays.

    mask: bool (B, H, W) tensor; dev_imgs: uint8 (B, H, W[, 3]) tensor on
    the same device."""
    if bg_downsample or fg_downsample:
        raise NotImplementedError('--bg-downsample / --fg-downsample are '
                                  'not ported')
    td = TimingData(timing_data)
    t0 = _time.time()
    fg = D.fg_layer(mask, dev_imgs)
    synchronize(fg.device)
    td.add('fg_partial_blur', t0)

    t0 = _time.time()
    bg = D.bg_layer(mask, dev_imgs)
    synchronize(bg.device)
    td.add('bg_partial_blur', t0)
    return fg.cpu().numpy(), bg.cpu().numpy()
