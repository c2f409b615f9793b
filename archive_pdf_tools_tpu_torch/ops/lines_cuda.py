"""Per-hOCR-line dual Sauvola thresholds: wrapper of the hand-written CUDA
kernel ``csrc/line_sauvola.cu`` (the port of ``ops/lines_pallas.py``),
and its plain PyTorch version.

Each line's bbox crop and its inverse ``255 - crop`` are thresholded at
k=0.1 with windows clamped to the crop (``mrc.py:188-270``).  The crops
are stored ragged: one flat uint8 buffer per polarity, line i's crop
row-major at ``offsets[i]`` (the host prefix sum of the line areas), so
crop row k of line i is page row t_i + k, cols [l_i, r_i).  A line of any
height takes the same path: no height buckets, no tall-line host patch,
no line capacity.

The kernel cuts each line into units of a row segment (``SEG_ROWS``) and
a column tile (``TILE_COLS``, plus the window's halo), one CTA each
(``line_units``); within a unit the rows that share one vertical window
(``window_runs``) are thresholded from one set of column sums as a
parallel map.  A line of any height or width takes that path.  A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  ``line_thresholds.launches`` counts the calls that launch it.
"""

import ctypes

import numpy as np
import torch

from ..utils import cudabuild
from .paste_cuda import paste_plan
from .sauvola import sauvola_constants, sauvola_mask

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {'apt_line_sauvola': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _F, _F, _P]}

# a unit of the kernel: up to SEG_ROWS rows x TILE_COLS output columns
# of a line (csrc/line_sauvola.cu; its column sums, three a thread of
# 256, hold TILE_COLS + window - 1 columns)
TILE_COLS = 512
SEG_ROWS = 64
# the window sum of squares (<= 65025 * window^2) is exact in uint32
MAX_WINDOW = 255


def line_strips(boxes, window, tile=TILE_COLS):
    """The kernel's column tiles: int32 (m, 3) rows (line, c0, c1), the
    output columns [c0, c1) of each, in line order, and the most columns a
    tile keeps sums of: its own plus the window's reach, o-1 columns to
    the left and u to the right, clamped to the line."""
    o, u = (window + 1) // 2, window // 2
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    l, r = boxes[:, 2], boxes[:, 3]
    cuts = -(-(r - l) // tile)
    line = np.repeat(np.arange(len(boxes)), cuts)
    k = np.arange(len(line)) - np.repeat(np.cumsum(cuts) - cuts, cuts)
    c0 = l[line] + k * tile
    c1 = np.minimum(c0 + tile, r[line])
    loaded = (np.minimum(c1 + u, r[line]) - np.maximum(c0 - o + 1, l[line]))
    return (np.stack([line, c0, c1], 1).astype(np.int32),
            int(loaded.max(initial=0)))


def line_units(boxes, window, tile=TILE_COLS, seg=SEG_ROWS):
    """The kernel's CTAs: int32 (m, 5) rows (line, y0, y1, c0, c1), a row
    segment times a column tile of each line, and (tiles, segs), the most
    of each a line has (the kernel's grid is lines x tiles x segs, and
    the CTAs past a line's own units return at once)."""
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    strips, _ = line_strips(boxes, window, tile)
    t, b = boxes[:, 0], boxes[:, 1]
    nseg = -(-(b - t) // seg)
    units = []
    for i, c0, c1 in strips:
        for k in range(nseg[i]):
            y0 = t[i] + k * seg
            units.append((i, y0, min(y0 + seg, b[i]), c0, c1))
    ntile = -(-(boxes[:, 3] - boxes[:, 2]) // tile)
    return (np.array(units, np.int32).reshape(-1, 5),
            (int(ntile.max(initial=0)), int(nseg.max(initial=0))))


def window_runs(t, b, y0, y1, window):
    """Rows [y0, y1) of a line [t, b) as runs that share one vertical
    window: (ya, yb, lo, hi) with window rows [lo, hi], as the kernel
    walks them."""
    o, u = (window + 1) // 2, window // 2
    runs, y = [], y0
    while y < y1:
        ye = min(y1, y + 1 if y - o + 1 > t else t + o)
        if y + u < b - 1:
            ye = min(ye, y + 1)
        runs.append((y, ye, max(y - o + 1, t), min(y + u, b - 1)))
        y = ye
    return runs


def distinct_windows(h, window):
    """The number of distinct vertical windows of a line of h rows."""
    o, u = (window + 1) // 2, window // 2
    return 1 + max(0, h - 1 - u) + max(0, h - o) - max(0, h - window)


class RaggedLines:
    """The hOCR lines of a page batch in document order, and their ragged
    crop layout.

    boxes: (n, 4) ints (top, bottom, left, right), inside (h, w);
    pages: (n,) page of each line.  Host numpy: ``boxes``, ``pages``,
    ``sizes`` ((b-t)*(r-l), int64) and ``offsets`` (n+1 prefix sums).
    On ``device``: ``table`` int32 (n, 5) rows (t, b, l, r, page) and
    ``dev_offsets`` int64 (n+1) and ``paste_plan``, the paste's line
    lists (``ops/paste_cuda.paste_plan``)."""

    def __init__(self, boxes, pages, batch, h, w, device):
        self.boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
        self.pages = np.asarray(pages, np.int64).reshape(-1)
        t, b, l, r = self.boxes.T
        if len(self.pages) != len(self.boxes):
            raise ValueError('RaggedLines: %d boxes but %d pages'
                             % (len(self.boxes), len(self.pages)))
        if ((t < 0) | (b > h) | (t >= b) | (l < 0) | (r > w) | (l >= r)
                | (self.pages < 0) | (self.pages >= batch)).any():
            raise ValueError('RaggedLines: a box is empty or outside the '
                             '%d pages of %dx%d' % (batch, h, w))
        self.n = len(self.boxes)
        self.batch, self.h, self.w = batch, h, w
        self.sizes = (b - t) * (r - l)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]) \
            .astype(np.int64)
        self.total = int(self.offsets[-1])
        table = np.concatenate([self.boxes, self.pages[:, None]], axis=1)
        self.table = torch.from_numpy(table.astype(np.int32)).to(device)
        self.dev_offsets = torch.from_numpy(self.offsets).to(device)
        # the paste's line lists (ops/paste_cuda.paste_plan), on device
        self.paste_plan = torch.from_numpy(
            paste_plan(self.boxes, self.pages, self.offsets[:-1], batch)) \
            .to(device)
        # the kernel's grid: the most column tiles and row segments a line
        # has (line_units)
        self.units = (-(-int((r - l).max(initial=0)) // TILE_COLS),
                      -(-int((b - t).max(initial=0)) // SEG_ROWS))

    @classmethod
    def from_page_boxes(cls, page_boxes, h, w, device):
        """From per-page lists of (t, b, l, r), e.g. ``prepare_lines``."""
        boxes = [bx for page in page_boxes for bx in page]
        pages = [p for p, page in enumerate(page_boxes) for _ in page]
        return cls(boxes, pages, len(page_boxes), h, w, device)

    def crop(self, flat, i):
        """Line i's crop, (b-t, r-l), as a view of a flat buffer."""
        t, b, l, r = (int(v) for v in self.boxes[i])
        o = int(self.offsets[i])
        return flat[o:o + (b - t) * (r - l)].reshape(b - t, r - l)


def line_thresholds_plain(gray, lines, window, k=0.1, R=128.0):
    """Per line, ``sauvola_mask`` of its crop and of ``255 - crop``."""
    out_t = torch.empty(lines.total, dtype=torch.uint8, device=gray.device)
    out_i = torch.empty_like(out_t)
    counts = torch.zeros((lines.n, 2), dtype=torch.int32, device=gray.device)
    for i in range(lines.n):
        t, b, l, r = (int(v) for v in lines.boxes[i])
        crop = gray[int(lines.pages[i]), t:b, l:r]
        m_t = sauvola_mask(crop, window, window, k, R)
        m_i = sauvola_mask(255 - crop, window, window, k, R)
        lines.crop(out_t, i).copy_(m_t)
        lines.crop(out_i, i).copy_(m_i)
        counts[i, 0] = m_t.sum()
        counts[i, 1] = m_i.sum()
    return out_t, out_i, counts


def line_thresholds(gray, lines, window, k=0.1, R=128.0):
    """gray: uint8 (B, H, W); lines: ``RaggedLines`` on gray's device.

    Returns (crops_t, crops_i, counts): the ragged uint8 0/1 crops of
    both polarities (flat, ``lines.total`` bytes each) and int32 (n, 2)
    per-line ink counts (plain, inverse)."""
    if gray.dtype != torch.uint8 or gray.dim() != 3:
        raise TypeError('line_thresholds: need a uint8 (B, H, W) image, got '
                        '%s %s' % (gray.dtype, tuple(gray.shape)))
    if tuple(gray.shape) != (lines.batch, lines.h, lines.w):
        raise ValueError('line_thresholds: lines laid out for %s, image is '
                         '%s' % ((lines.batch, lines.h, lines.w),
                                 tuple(gray.shape)))
    if lines.table.device != gray.device:
        raise ValueError('line_thresholds: image on %s, lines on %s'
                         % (gray.device, lines.table.device))
    if window < 1 or window % 2 != 1 or window > MAX_WINDOW:
        raise ValueError('line_thresholds: window must be odd and <= %d, '
                         'got %d' % (MAX_WINDOW, window))
    if k < 0:
        raise ValueError('line_thresholds: k >= 0 only')
    if gray.device.type == 'cpu':
        return line_thresholds_plain(gray, lines, window, k, R)
    if gray.device.type != 'cuda':
        raise ValueError('line_thresholds: unsupported device %s'
                         % gray.device)
    if not gray.is_contiguous():
        raise ValueError('line_thresholds: image must be contiguous')
    out_t = torch.empty(lines.total, dtype=torch.uint8, device=gray.device)
    out_i = torch.empty_like(out_t)
    if lines.n == 0:
        return out_t, out_i, torch.empty((0, 2), dtype=torch.int32,
                                         device=gray.device)
    tiles, segs = lines.units
    # every unit adds its ink counts into its line's (zeroed by the launch)
    counts = torch.empty((lines.n, 2), dtype=torch.int32, device=gray.device)
    km1, k2 = sauvola_constants(k, R)
    lib = cudabuild.load('line_sauvola', _SIGNATURES)
    b, h, w = gray.shape
    with torch.cuda.device(gray.device):
        stream = torch.cuda.current_stream(gray.device).cuda_stream
        err = lib.apt_line_sauvola(
            gray.data_ptr(), lines.table.data_ptr(),
            lines.dev_offsets.data_ptr(), out_t.data_ptr(),
            out_i.data_ptr(), counts.data_ptr(), lines.n, h, w, tiles, segs,
            int(window), float(km1), float(k2), stream)
    cudabuild.check(err, 'line_thresholds')
    line_thresholds.launches += 1
    return out_t, out_i, counts


line_thresholds.launches = 0
