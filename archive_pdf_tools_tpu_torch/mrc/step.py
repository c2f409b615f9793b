"""The fused MRC step as one call of tensors: the counterpart of the JAX
package's ``mrc/step.py:mrc_full_step_pallas``.

hOCR line thresholds (K4), the noise-adaptive global threshold (K3), the
ordered paste of the selected crops (K5), the despeckle (K2) and both
radiate fills (K1), in the JAX order.  The line selection is an input
(the host heuristic runs before, as in the JAX step), so the step is a
pure function of its tensors: the unit of device work that a page shard
runs (``parallel/sharded.py:sharded_mrc_step``).  Each stage calls the
kernel wrapper the main path (``mrc/api.py``) calls; the device the
images sit on decides where the step runs.

Line slots follow the JAX convention: ``boxes`` (4, n) rows (t, b, l,
r), slot 0 a 1x1 dummy box, unused slots all zero (empty).  The kernels
take ragged lines (``ops/lines_cuda.RaggedLines``), which hold no empty
box, so ``lines_from_slots`` keeps the non-empty slots in slot order.
"""

from collections import namedtuple

import numpy as np
import torch

from ..const import DENOISE_FAST
from ..ops.lines_cuda import RaggedLines
from ..parallel.sharded import (sharded_denoise, sharded_global_threshold,
                                sharded_line_thresholds, sharded_optimise,
                                sharded_paste)
from . import decompose as D


SlotLines = namedtuple('SlotLines', 'lines selector keep n')


def lines_from_slots(boxes, pages, selector, batch, h, w, device):
    """The non-empty slots of (4, n) ``boxes`` as ``RaggedLines`` on
    ``device``, in slot order (document order, so the paste's last
    writer is the JAX step's).  -> ``SlotLines``: the lines, their host
    selector, the slot of each (int64 on ``device``) and n."""
    boxes = np.asarray(boxes, np.int64).reshape(4, -1)
    pages = np.asarray(pages, np.int64).reshape(-1)
    selector = np.asarray(selector, np.int32).reshape(-1)
    t, b, l, r = boxes
    keep = np.flatnonzero((b > t) & (r > l))
    lines = RaggedLines(boxes[:, keep].T, pages[keep], batch, h, w, device)
    return SlotLines(lines, selector[keep],
                     torch.from_numpy(keep).to(device), boxes.shape[1])


def _slot_counts(crops, slots):
    """The kept lines' ink counts scattered back to int32 (n,) slots
    (zero for an empty slot): (ones, ones_inv)."""
    out = torch.zeros((2, slots.n), dtype=torch.int32,
                      device=slots.keep.device)
    if crops is not None:
        out[:, slots.keep] = crops[2].T
    return out[0], out[1]


def step_shards(images, slots, window, rgb=False, denoise=DENOISE_FAST,
                blur_radius=None, taps=None):
    """The step over page shards, each on its device: ``images`` a list
    of uint8 (b, H, W[, 3]) tensors, ``slots`` each one's
    ``lines_from_slots``.  Every shard's launches are issued before the
    one host sync, the read of the noise estimates for the blur taps
    (none with ``taps``, a list of per-shard taps).  -> lists (masks,
    fgs, bgs, counts), one entry a shard, counts (ones, ones_inv)."""
    grays = [D.gray_601(x) for x in images] if rgb else list(images)
    lines = [s.lines for s in slots]
    crops = sharded_line_thresholds(grays, lines, window)
    masks = sharded_global_threshold(grays, window, blur_radius, taps)
    masks = sharded_paste(crops, lines, [s.selector for s in slots], masks)
    if denoise == DENOISE_FAST:
        masks = sharded_denoise(masks, DENOISE_FAST)
    fgs = sharded_optimise(masks, images, 3)
    bgs = sharded_optimise(masks, images, 10, invert=True)
    counts = [_slot_counts(c, s) for c, s in zip(crops, slots)]
    return masks, fgs, bgs, counts


def mrc_full_step(images, boxes, pages, selector, window, rgb=False,
                  denoise=DENOISE_FAST, blur_radius=None, taps=None):
    """images: uint8 (B, H, W) or (B, H, W, 3) on the device to run on;
    boxes: int (4, n) line slots; pages: (n,) page of each slot;
    selector: (n,) per-slot pick (0 none / 1 plain / 2 inverse) from the
    host heuristic.

    blur_radius: None picks the smallest radius bucket covering the
    batch's noise, as the main path does
    (``parallel/sharded.sharded_global_threshold``), so the step gives
    ``decompose_masks`` + ``decompose_layers``' bytes; 16 is the JAX
    step's fixed buffer.  taps: the JAX package's per-page
    blur taps (numpy f32 (B, 2R+1)), carried across with
    ``decompose.from_jax_state`` in place of the noise estimate.

    Returns (mask bool, fg uint8, bg uint8, (ones, ones_inv)), the JAX
    step's tuple; ones and ones_inv are int32 (n,), one per slot."""
    b, h, w = images.shape[:3]
    slots = lines_from_slots(boxes, pages, selector, b, h, w, images.device)
    if taps is not None:
        taps, window = D.from_jax_state(taps, window, 'cpu')
        taps = [taps]
    (mask,), (fg,), (bg,), (counts,) = step_shards(
        [images], [slots], window, rgb, denoise, blur_radius, taps)
    return mask, fg, bg, counts
