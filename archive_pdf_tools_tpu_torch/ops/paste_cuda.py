"""Ordered paste of the selected line crops: wrapper of the hand-written
CUDA kernel ``csrc/paste.cu`` (the port of ``ops/paste_pallas.py``), and
its plain PyTorch version.

The crop of each selected line (selector 1 = plain, 2 = inverse, 0 =
none) overwrites its box in document order, so the last selected line
wins an overlap; then the global mask is OR-ed in (``mrc.py:265-266,
329``).  The plain version is that sequential scan (the JAX package's
``mrc/decompose.py:paste_selected_crops``) over the ragged crops of
``ops/lines_cuda.py``.

The kernel pastes tile by tile; ``paste_plan`` lists, for each page, its
lines in document order (the rows of ``RaggedLines`` need not be sorted
by page), and each tile walks the selected ones that meet it in that
order, so the last selected line wins as in the sequential scan.

A CPU tensor runs the plain version; a CUDA tensor launches the kernel
or raises.  ``paste_lines.launches`` counts the kernel launches.
"""

import ctypes

import numpy as np
import torch

from ..utils import cudabuild

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {'apt_paste': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]}


def paste_plan(boxes, pages, offsets, batch):
    """The kernel's line lists for lines of ``boxes`` (n, 4), ``pages``
    (n,) and crop ``offsets`` (n,): int32, the ``batch + 1`` page starts
    (padded to a multiple of 4), then for the lines of each page in
    document order a record of 8: (t, b, l, r, crop offset low and high
    words, line index, 0).  The lines need not be sorted by page: a
    stable sort by page keeps document order within each.  The selector
    is not in the plan, so ``RaggedLines`` builds it once for its lines."""
    head = -(-(batch + 1) // 4) * 4
    order = np.argsort(pages, kind='stable')
    plan = np.zeros(head + 8 * len(order), np.int64)
    np.cumsum(np.bincount(pages, minlength=batch), out=plan[1:batch + 1])
    recs = plan[head:].reshape(-1, 8)
    recs[:, :4] = boxes[order]
    recs[:, 4] = offsets[order] & 0xFFFFFFFF
    recs[:, 5] = offsets[order] >> 32
    recs[:, 6] = order
    return plan.astype(np.uint32).view(np.int32)


def paste_lines_plain(crops_t, crops_i, lines, selector, gmask):
    page = torch.zeros(gmask.shape, dtype=torch.uint8, device=gmask.device)
    for i in np.flatnonzero(selector):
        t, b, l, r = (int(v) for v in lines.boxes[i])
        src = crops_t if selector[i] == 1 else crops_i
        page[int(lines.pages[i]), t:b, l:r] = lines.crop(src, i)
    return (page != 0) | gmask


def paste_lines(crops_t, crops_i, lines, selector, gmask):
    """crops_*: the ragged uint8 crops of ``line_thresholds``; lines:
    their ``RaggedLines``; selector: (n,) ints 0/1/2 per line (host);
    gmask: bool (B, H, W).  Returns bool (B, H, W)."""
    selector = np.asarray(selector, np.int32).reshape(-1)
    if gmask.dtype != torch.bool or gmask.dim() != 3:
        raise TypeError('paste_lines: need a bool (B, H, W) mask, got %s %s'
                        % (gmask.dtype, tuple(gmask.shape)))
    if tuple(gmask.shape) != (lines.batch, lines.h, lines.w):
        raise ValueError('paste_lines: lines laid out for %s, mask is %s'
                         % ((lines.batch, lines.h, lines.w),
                            tuple(gmask.shape)))
    if len(selector) != lines.n or ((selector < 0) | (selector > 2)).any():
        raise ValueError('paste_lines: need one selector in {0, 1, 2} per '
                         'line (%d lines)' % lines.n)
    for c in (crops_t, crops_i):
        if c.dtype != torch.uint8 or c.shape != (lines.total,):
            raise ValueError('paste_lines: crops must be flat uint8 of %d '
                             'bytes, got %s %s' % (lines.total, c.dtype,
                                                   tuple(c.shape)))
        if c.device != gmask.device:
            raise ValueError('paste_lines: crops on %s, mask on %s'
                             % (c.device, gmask.device))
    if gmask.device.type == 'cpu':
        return paste_lines_plain(crops_t, crops_i, lines, selector, gmask)
    if gmask.device.type != 'cuda':
        raise ValueError('paste_lines: unsupported device %s' % gmask.device)
    if lines.table.device != gmask.device:
        raise ValueError('paste_lines: lines on %s, mask on %s'
                         % (lines.table.device, gmask.device))
    if not gmask.is_contiguous():
        raise ValueError('paste_lines: mask must be contiguous')
    lib = cudabuild.load('paste', _SIGNATURES)
    b, h, w = gmask.shape
    out = torch.empty_like(gmask)
    with torch.cuda.device(gmask.device):
        # from pinned memory, so the host need not wait for the stream (a
        # pageable copy may); the caching host allocator keeps the buffer
        # until the copy is done
        sel = torch.from_numpy(selector).pin_memory().to(gmask.device,
                                                        non_blocking=True)
        err = lib.apt_paste(crops_t.data_ptr(), crops_i.data_ptr(),
                            lines.paste_plan.data_ptr(), sel.data_ptr(),
                            gmask.data_ptr(), out.data_ptr(), b, h, w,
                            torch.cuda.current_stream(
                                gmask.device).cuda_stream)
    cudabuild.check(err, 'paste_lines')
    paste_lines.launches += 1
    return out


paste_lines.launches = 0
