"""Page-shard execution of the kernel path: the counterpart of the JAX
package's ``parallel/sharded.py``.

The JAX package wraps each Pallas kernel in ``shard_map`` over a 1-D
'pages' mesh.  Here a shard is a tensor on its device, and each
``sharded_*`` function takes a list of them and launches its kernel on
every shard before it waits for anything, so shards on separate cards
overlap.  With one shard each is the single-device stage, so
``mrc/api.py`` and ``mrc/step.py`` run one code path for one device and
for many.  Each shard's hOCR lines are a ``RaggedLines`` of its own, with
page indices local to the shard.

Every kernel works page by page, so a split changes no byte, with one
exception the functions here take care of: the blur's radius bucket
must come from the whole batch (``sharded_global_threshold``).
"""

import numpy as np

from ..mrc import decompose as D
from ..ops.lines_cuda import line_thresholds
from ..ops.optimise_cuda import optimise
from ..ops.paste_cuda import paste_lines
from ..ops.sigma import estimate_noise
from ..ops.threshold_cuda import blur_sauvola
from ..utils.backend import to_device
from .mesh import gather_pages, shard_pages


def sharded_line_thresholds(grays, lines, window):
    """K4 on every shard: per shard ``line_thresholds``' (crops_t,
    crops_i, counts), or None for a shard without lines."""
    return [line_thresholds(g, ln, window) if ln.n else None
            for g, ln in zip(grays, lines)]


def sharded_global_threshold(grays, window, radius=None, taps=None):
    """K3 on every shard, with one blur radius bucket for all of them:
    the smallest covering the whole batch's noise (or ``radius``), as
    the single-device path picks it, so the masks are its bytes.  The
    noise estimates run on every shard first; reading them is the one
    host sync.  ``taps``: per-shard taps to use instead (no estimate)."""
    if taps is None:
        taps = D.blur_taps([estimate_noise(g) for g in grays], radius)
    return [blur_sauvola(g, to_device(t, g.device), window)
            for g, t in zip(grays, taps)]


def sharded_paste(crops, lines, selectors, gmasks):
    """K5 on every shard with lines: its selected crops over its global
    mask, in document order."""
    return [m if c is None else paste_lines(c[0], c[1], ln, s, m)
            for c, ln, s, m in zip(crops, lines, selectors, gmasks)]


def sharded_denoise(masks, mode, exact=True):
    """The mask despeckle on every shard (K2 for ``'fast'``)."""
    return [D.denoise_mask(m, mode, exact) for m in masks]


def sharded_optimise(masks, images, n, invert=False):
    """K1 on every shard: fg (n=3, ``mrc.py:408-415``) on the mask, or
    with ``invert`` bg (n=10, ``mrc.py:439-449``) on its inverse."""
    return [optimise(~m if invert else m, x, n)
            for m, x in zip(masks, images)]


def sharded_mrc_step(devices, window, rgb=False, denoise='fast'):
    """The full step (``mrc/step.py:mrc_full_step``) on each device's
    page shard.

    Returns fn(images (B, H, W[, 3]), boxes (D, 4, n), pages (D, n),
    selector (D, n)) -> (mask, fg, bg) on the images' device, where D is
    ``len(devices)`` and each shard's line slots use page indices local
    to it (``split_lines_per_shard`` makes them from global ones).  The
    blur bucket is the whole batch's, so the result is the one-device
    step's, byte for byte."""
    # mrc/step.py builds on the functions above
    from ..mrc.step import lines_from_slots, step_shards

    def step(images, boxes, pages, selector):
        shards = shard_pages(devices, images)
        per, h, w = shards[0].shape[:3]
        # the lines' host work and uploads, before any launch
        slots = [lines_from_slots(boxes[s], pages[s], selector[s], per, h,
                                  w, x.device)
                 for s, x in enumerate(shards)]
        mask, fg, bg, _ = step_shards(shards, slots, window, rgb, denoise)
        return tuple(gather_pages(p, images.device) for p in (mask, fg, bg))
    return step


# copy_shared: archive_pdf_tools_tpu/parallel/sharded.py:148-170
def split_lines_per_shard(boxes, pages, selector, batch, n_shards):
    """Host helper: scatter global line arrays into per-shard arrays
    with local page indices (page p -> shard p // (batch/n_shards))."""
    per = batch // n_shards
    n = boxes.shape[1]
    out_boxes = np.zeros((n_shards, 4, n), np.int32)
    out_pages = np.zeros((n_shards, n), np.int32)
    out_sel = np.zeros((n_shards, n), np.int32)
    # dummy slot 0 convention
    out_boxes[:, 1, 0] = 1
    out_boxes[:, 3, 0] = 1
    fill = [1] * n_shards
    for i in range(1, n):
        p = int(pages[i])
        s = p // per
        if s >= n_shards or fill[s] >= n:
            continue
        j = fill[s]
        fill[s] = j + 1
        out_boxes[s, :, j] = boxes[:, i]
        out_pages[s, j] = p - s * per
        out_sel[s, j] = selector[i]
    return out_boxes, out_pages, out_sel
# copy_shared: end
