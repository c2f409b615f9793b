"""The port's fused MRC step (``mrc/step.py:mrc_full_step``) held against
the JAX package's ``mrc_full_step_pallas`` (its Pallas kernels in
interpret mode, with and without the JAX paste plan), and against the
port's own main path (``decompose_masks`` + ``decompose_layers``).

Noise-free pages have identity blur taps on both sides, so everything
is bit-equal.  On noisy pages the JAX taps are carried across
(``taps=``): the blur's float sums then run in the port's order and
XLA's, and the masks agree at K3's bar against XLA's blur (>= 0.9999);
the fills given one mask are exact.
"""

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu.mrc import decompose as JD
from archive_pdf_tools_tpu.mrc.step import mrc_full_step_pallas
from archive_pdf_tools_tpu.ops.optimise_pallas import optimise_pallas
from archive_pdf_tools_tpu.ops.paste_pallas import build_paste_plan

from archive_pdf_tools_tpu_torch.mrc import api as TA
from archive_pdf_tools_tpu_torch.mrc import decompose as TD
from archive_pdf_tools_tpu_torch.mrc.hocr_prep import prepare_lines
from archive_pdf_tools_tpu_torch.mrc.step import lines_from_slots, \
    mrc_full_step
from archive_pdf_tools_tpu_torch.ops.lines_cuda import RaggedLines, \
    line_thresholds
from archive_pdf_tools_tpu_torch.ops.sauvola import sauvola_window

from __graft_entry__ import _example_inputs
from tests.fixtures import render_book_page
from tests.scanfix import synth_scan

torch.set_num_threads(2)

PLAN_KEYS = ('li', 't', 'b', 'l', 'r', 'sel', 'gpage', 'gfirst')


def _rgb(p):
    return np.stack([p, np.clip(p.astype(int) + 7, 0, 255),
                     np.clip(p.astype(int) - 7, 0, 255)], -1) \
        .astype(np.uint8)


def _book_lines(words):
    """render_book_page's words grouped into line boxes (t, b, l, r)."""
    rows = {}
    for x0, y0, x1, y1, _ in words:
        rows.setdefault(y0, []).append((x0, y1, x1))
    return [(y0, max(b for _, b, _ in ws), min(l for l, _, _ in ws),
             max(r for _, _, r in ws)) for y0, ws in sorted(rows.items())]


def _slots(page_boxes, n=None, gaps=False, seed=0):
    """The JAX slot layout of per-page line boxes: slot 0 the 1x1 dummy,
    then the lines in page order, with ``gaps`` an empty slot after
    every second line, padded with empty slots to n (by default to a
    multiple of 8, as the JAX kernel pads its line slots); the lines'
    selector cycles 0, 1, 2 from ``seed`` (0 for the dummy and the empty
    slots)."""
    cols, pages = [(0, 1, 0, 1)], [0]
    for p, boxes in enumerate(page_boxes):
        for i, box in enumerate(boxes):
            cols.append(tuple(box))
            pages.append(p)
            if gaps and i % 2:
                cols.append((0, 0, 0, 0))
                pages.append(0)
    n = n or -(-len(cols) // 8) * 8
    boxes = np.zeros((4, n), np.int32)
    boxes[:, :len(cols)] = np.array(cols, np.int32).T
    pg = np.zeros(n, np.int32)
    pg[:len(pages)] = pages
    line = (boxes[1] > boxes[0]) & (np.arange(n) > 0)
    sel = np.zeros(n, np.int32)
    sel[line] = (np.arange(line.sum()) + seed) % 3
    return boxes, pg, sel


def _graft_slots():
    _imgs, _lid, boxes, use_plain, _inv = _example_inputs(2, 96, 160)
    pages = np.zeros(boxes.shape[1], np.int32)
    pages[1:7] = [0, 0, 0, 1, 1, 1]
    return boxes, pages, np.where(use_plain, 1, 0).astype(np.int32)


def _case(name):
    """(images, boxes, pages, selector, window, rgb, denoise, plan)."""
    if name == 'graft-gray-fast':
        # __graft_entry__'s slots over noise-free rendered pages
        imgs = np.stack([render_book_page(160, 96, seed=s, noise=0)[0]
                         for s in range(2)])
        return (imgs,) + _graft_slots() + (15, False, 'fast', False)
    if name == 'book-rgb-none-plan':
        pages = [render_book_page(192, 128, seed=s, noise=0, rgb=True)
                 for s in range(3)]
        slots = _slots([_book_lines(w) for _, w in pages], n=64,
                       gaps=True, seed=1)
        return (np.stack([p for p, _ in pages]),) + slots + \
            (31, True, 'none', True)
    scans = [synth_scan(h=224, w=256, seed=s, dpi=150, noise_sigma=0)
             for s in (1, 2)]
    boxes = [prepare_lines(wd, 256, 224) for _, wd in scans]
    imgs = np.stack([p for p, _ in scans])
    if name == 'scan-gray-none-plan':
        return (imgs,) + _slots(boxes, gaps=True, seed=2) + \
            (31, False, 'none', True)
    assert name == 'scan-rgb-fast'
    return (np.stack([_rgb(p) for p in imgs]),) + \
        _slots(boxes, n=48, seed=3) + (15, True, 'fast', False)


def _jax_step(imgs, boxes, pages, sel, window, rgb, denoise, plan):
    paste_plan = None
    if plan:
        p = build_paste_plan(boxes, pages, sel, imgs.shape[0])
        paste_plan = tuple(p[k] for k in PLAN_KEYS)
    out = mrc_full_step_pallas(imgs, boxes, pages, sel, window=window,
                               rgb=rgb, denoise=denoise, interpret=True,
                               blur_radius=16, paste_plan=paste_plan)
    mask, fg, bg, (ones, ones_inv) = out
    return [np.asarray(a) for a in (mask, fg, bg, ones, ones_inv)]


def _port_step(imgs, boxes, pages, sel, window, rgb, denoise, **kw):
    mask, fg, bg, (ones, ones_inv) = mrc_full_step(
        torch.from_numpy(imgs), boxes, pages, sel, window, rgb=rgb,
        denoise=denoise, **kw)
    return [t.numpy() for t in (mask, fg, bg, ones, ones_inv)]


@pytest.mark.parametrize('name', ['graft-gray-fast', 'book-rgb-none-plan',
                                  'scan-gray-none-plan', 'scan-rgb-fast'])
def test_noise_free_step_bit_equal_to_jax(name):
    imgs, boxes, pages, sel, window, rgb, denoise, plan = _case(name)
    assert (sel == 1).any()
    ref = _jax_step(imgs, boxes, pages, sel, window, rgb, denoise, plan)
    got = _port_step(imgs, boxes, pages, sel, window, rgb, denoise,
                     blur_radius=16)
    for what, g, r in zip(('mask', 'fg', 'bg', 'ones', 'ones_inv'), got,
                          ref):
        assert g.shape == r.shape and g.dtype == r.dtype, what
        assert (g == r).all(), what
    assert got[0].any() and not got[0].all()
    assert got[3][1:].any() and got[4][1:].any()
    # an empty slot counts nothing
    empty = boxes[1] <= boxes[0]
    assert not got[3][empty].any() and not got[4][empty].any()


def _noisy_case(name):
    if name == 'graft-random':
        imgs = _example_inputs(2, 96, 160)[0]
        return (imgs,) + _graft_slots() + (15, False, 'fast')
    scans = [synth_scan(h=160, w=256, seed=s, dpi=150, noise_sigma=14)
             for s in (4, 5)]
    slots = _slots([prepare_lines(wd, 256, 160) for _, wd in scans],
                   gaps=True, seed=4)
    return (np.stack([_rgb(p) for p, _ in scans]),) + slots + \
        (31, True, 'none')


@pytest.mark.parametrize('name', ['graft-random', 'scan-rgb-noisy'])
def test_noisy_step_with_jax_taps_agrees(name):
    imgs, boxes, pages, sel, window, rgb, denoise = _noisy_case(name)
    gray = JD.gray_601(imgs) if rgb else imgs
    taps, sigma = JD.blur_weights(gray, max_radius=16)
    assert (np.asarray(sigma) > 1).all()        # real taps, not identity
    ref = _jax_step(imgs, boxes, pages, sel, window, rgb, denoise, False)
    got = _port_step(imgs, boxes, pages, sel, window, rgb, denoise,
                     taps=np.array(taps))
    assert (got[0] == ref[0]).mean() >= 0.9999
    assert (got[3] == ref[3]).all() and (got[4] == ref[4]).all()
    for p in range(imgs.shape[0]):
        if (got[0][p] == ref[0][p]).all():
            assert (got[1][p] == ref[1][p]).all()
            assert (got[2][p] == ref[2][p]).all()
    # the fills of the JAX mask are the JAX fills, bit for bit
    jm = ref[0]
    fg = optimise_pallas(jm, imgs, 3, interpret=True)
    assert (np.asarray(fg) == ref[1]).all()
    tfg, tbg = TA.decompose_layers(torch.from_numpy(jm),
                                   torch.from_numpy(imgs))
    assert (tfg == ref[1]).all() and (tbg == ref[2]).all()


@pytest.mark.parametrize('rgb', [False, True])
def test_step_equals_the_main_path(rgb):
    """blur_radius=None picks the bucket as decompose_masks does: with
    the selector decompose_masks picks, the step is the main path's
    bytes, on noisy pages whose taps are real."""
    dpi = 150
    scans = [synth_scan(h=192, w=288, seed=s, dpi=dpi, noise_sigma=11)
             for s in (6, 7)]
    pages = [_rgb(p) if rgb else p for p, _ in scans]
    wds = [wd for _, wd in scans]
    mask, dev = TA.decompose_masks(pages, wds, dpi=dpi, device='cpu')
    fg, bg = TA.decompose_layers(mask, dev)

    imgs = np.stack(pages)
    gray = TD.gray_601(torch.from_numpy(imgs)) if rgb \
        else torch.from_numpy(imgs)
    window = sauvola_window(dpi)
    page_boxes = [prepare_lines(wd, 288, 192) for wd in wds]
    lines = RaggedLines.from_page_boxes(page_boxes, 192, 288, 'cpu')
    sel = TD.line_selector(*line_thresholds(gray, lines, window), lines)
    assert (sel == 1).any()
    boxes, spages, _ = _slots(page_boxes)
    ssel = np.concatenate([[0], sel]).astype(np.int32)
    got = _port_step(imgs, boxes, spages, ssel, window, rgb, 'fast')
    assert (got[0] == mask.numpy()).all()
    assert (got[1] == fg).all() and (got[2] == bg).all()


def test_lines_from_slots_keeps_slot_order():
    boxes = np.array([[0, 1, 0, 1], [0, 0, 0, 0], [5, 9, 2, 20],
                      [3, 3, 4, 9], [1, 6, 0, 8]], np.int32).T
    pages = np.array([0, 0, 1, 0, 0])
    sel = np.array([0, 0, 2, 0, 1])
    s = lines_from_slots(boxes, pages, sel, 2, 10, 30, 'cpu')
    assert s.n == 5 and s.keep.tolist() == [0, 2, 4]
    assert s.lines.boxes.tolist() == [[0, 1, 0, 1], [5, 9, 2, 20],
                                      [1, 6, 0, 8]]
    assert s.lines.pages.tolist() == [0, 1, 0]
    assert s.selector.tolist() == [0, 2, 1]
