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
dpi-window).  Each stage is a span (``utils/spans.py``) of the
reference's timing key; each stage ends with a device synchronise so its
time is the device's, not the enqueue.
"""

import numpy as np
import torch

from ..const import (
    DENOISE_FAST, DENOISE_NONE, RECODE_RUNTIME_WARNING_TOO_SMALL_TO_DOWNSAMPLE)
from ..ops.lines_cuda import RaggedLines
from ..ops.resize import downsample_layer
from ..ops.sauvola import sauvola_window
from ..parallel.mesh import gather_pages, shard_pages, split_devices
from ..parallel.sharded import (sharded_denoise, sharded_global_threshold,
                                sharded_line_thresholds, sharded_optimise,
                                sharded_paste)
from ..utils.backend import resolve_device, synchronize
from ..utils.spans import span
from . import decompose as D
from .hocr_prep import prepare_lines


def decompose_masks(np_images, word_datas, dpi=None, downsample=None,
                    denoise_mask=DENOISE_FAST, exact_denoise=True,
                    timing_data=None, device=None, devices=None):
    """Mask phase for a uniform batch.

    np_images: list of uint8 arrays, all (H, W) gray or (H, W, 3) RGB of
    identical shape, or a uint8 (B, H, W[, 3]) tensor; word_datas: the
    hOCR word data of each page (line boxes are divided by
    ``downsample`` when the pages were).  Returns
    (bool (B, H, W) mask, uint8 page tensor), both on ``device``
    (default the first GPU; ``'cpu'`` runs the plain PyTorch versions).

    devices: the counterpart of the JAX package's ``mesh``: a list of
    devices (``parallel/mesh.py``; one may repeat) the batch shards over,
    contiguous pages a device, each shard's kernels on its device and the
    mask gathered on ``device``.  A batch smaller than the device count,
    or one that does not divide by it, runs on ``device`` alone.  Each
    line's selection depends on that line alone, and a shard's lines are
    its pages' lines in document order, so the bytes are the one-device
    run's.

    Timing keys: ``grey_conversion`` (RGB), ``hocr_mask_gen`` (line
    preparation, line thresholds, selection), ``threshold`` (global
    threshold and the ordered paste), ``fast_denoise`` (``denoise`` for
    bregman)."""
    dev = resolve_device(device)
    if isinstance(np_images, torch.Tensor):
        imgs = np_images
    else:
        imgs = np.stack(np_images)
    rgb = imgs.ndim == 4
    h, w = imgs.shape[1], imgs.shape[2]
    window = sauvola_window(dpi)
    shards = split_devices(devices, imgs.shape[0]) or [dev]
    per = imgs.shape[0] // len(shards)
    used = set(shards)

    def upload():
        dev_imgs = torch.as_tensor(imgs).to(dev)
        return dev_imgs, shard_pages(shards, dev_imgs)

    if rgb:
        with span('grey_conversion', timing_data):
            dev_imgs, shard_imgs = upload()
            grays = [D.gray_601(x) for x in shard_imgs]
            _synchronize(used)
    else:
        dev_imgs, grays = upload()

    # the (host) line preparation is part of this stage, as in the JAX
    # package
    with span('hocr_mask_gen', timing_data):
        page_boxes = [prepare_lines(wd, w, h, downsample=downsample)
                      for wd in word_datas]
        lines = [RaggedLines.from_page_boxes(
                     page_boxes[s * per:(s + 1) * per], h, w, d)
                 for s, d in enumerate(shards)]
        crops = sharded_line_thresholds(grays, lines, window)
        selectors = [None if c is None else D.line_selector(*c, ln)
                     for c, ln in zip(crops, lines)]

    with span('threshold', timing_data):
        masks = sharded_global_threshold(grays, window)
        masks = sharded_paste(crops, lines, selectors, masks)
        _synchronize(used)

    if denoise_mask is not None and denoise_mask != DENOISE_NONE:
        with span('fast_denoise' if denoise_mask == DENOISE_FAST
                  else 'denoise', timing_data):
            masks = sharded_denoise(masks, denoise_mask, exact_denoise)
            _synchronize(used)
    return gather_pages(masks, dev), dev_imgs


def decompose_layers(mask, dev_imgs, bg_downsample=None, fg_downsample=None,
                     timing_data=None, errors=None, device=False,
                     devices=None):
    """fg/bg phase: the radiate fills and the optional layer downsampling,
    as uint8 numpy arrays (downsampled sizes if requested), or with
    ``device=True`` as tensors left on the device, for a device consumer
    (the ``-J tpu`` batch transform).

    mask: bool (B, H, W) tensor; dev_imgs: uint8 (B, H, W[, 3]) tensor on
    the same device.  devices: as for ``decompose_masks``; the fills run
    on each device's shard, the layers gathered on the mask's device.
    ``errors`` (a set) collects the reference's too-small-to-downsample
    warning."""
    home = mask.device
    shards = split_devices(devices, mask.shape[0]) or [home]
    used = set(shards) | {home}
    masks, imgs = shard_pages(shards, mask, dev_imgs)
    with span('fg_partial_blur', timing_data):
        fg = gather_pages(sharded_optimise(masks, imgs, 3), home)
        _synchronize(used)
    if fg_downsample:
        with span('fg_downsample', timing_data):
            fg = _downsample(fg, fg_downsample, errors)
            synchronize(home)

    with span('bg_partial_blur', timing_data):
        bg = gather_pages(sharded_optimise(masks, imgs, 10, invert=True),
                          home)
        _synchronize(used)
    if bg_downsample:
        with span('bg_downsample', timing_data):
            bg = _downsample(bg, bg_downsample, errors)
            synchronize(home)
    if device:
        return fg, bg
    return fg.cpu().numpy(), bg.cpu().numpy()


def _synchronize(devices):
    for d in devices:
        synchronize(d)


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
        with span('grey_conversion', timing_data):
            image = image.convert('RGB')

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
