"""The line kernels' plain PyTorch versions (the CPU path of the K4 and K5
wrappers) held against the reference oracle ``ops/golden.py`` and the
JAX package's Pallas kernels in interpret mode.

K4 (``ops/lines_cuda.line_thresholds``): per-line dual Sauvola crops,
ragged, and their ink counts.  K5 (``ops/paste_cuda.paste_lines``): the
ordered paste of the selected crops, OR the global mask.  The kernels
themselves run only on a GPU and are compared with these plain versions
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archive_pdf_tools_tpu.ops import golden
from archive_pdf_tools_tpu.ops.lines_pallas import line_thresholds_pallas
from archive_pdf_tools_tpu.ops.paste_pallas import (build_paste_plan,
                                                    paste_crops_pallas)
from archive_pdf_tools_tpu.mrc import decompose as JD

from archive_pdf_tools_tpu_torch.ops.lines_cuda import (RaggedLines,
                                                        line_thresholds)
from archive_pdf_tools_tpu_torch.ops.paste_cuda import paste_lines

from tests.test_kernels import synth_page

torch.set_num_threads(2)

# tests/test_pallas.py:152-174: rows (t, b, l, r), pages
PALLAS_BOXES = np.array([[20, 60, 100, 250],
                         [30, 75, 25, 230],
                         [70, 115, 5, 245]])
PALLAS_PAGES = np.array([0, 1, 1])


def _port_lines(gray, boxes, pages, window):
    lines = RaggedLines(boxes, pages, *gray.shape, device='cpu')
    ct, ci, counts = line_thresholds(torch.from_numpy(gray), lines, window)
    return lines, ct, ci, counts.numpy()


def _golden_check(gray, boxes, pages, window):
    lines, ct, ci, counts = _port_lines(gray, boxes, pages, window)
    for i, (t, b, l, r) in enumerate(boxes):
        crop = gray[pages[i], t:b, l:r]
        ref = golden.sauvola_mask_ref(crop, window, window, 0.1)
        refi = golden.sauvola_mask_ref(255 - crop, window, window, 0.1)
        assert (lines.crop(ct, i).numpy() == ref).all(), i
        assert (lines.crop(ci, i).numpy() == refi).all(), i
        assert counts[i, 0] == ref.sum() and counts[i, 1] == refi.sum()
    return lines, ct, ci, counts


def test_line_crops_match_golden_and_pallas_interpret():
    gray = np.stack([synth_page(120, 250, seed=s) for s in range(2)])
    lines, ct, ci, counts = _golden_check(gray, PALLAS_BOXES, PALLAS_PAGES,
                                          51)
    th, ti, ones, ones_inv = line_thresholds_pallas(
        gray, PALLAS_BOXES.T.astype(np.int32), PALLAS_PAGES.astype(np.int32),
        51, 0.1, interpret=True)
    th, ti = np.asarray(th), np.asarray(ti)
    for i, (t, b, l, r) in enumerate(PALLAS_BOXES):
        off = t % 8           # Pallas crop rows are 8-aligned
        assert (lines.crop(ct, i).numpy() == th[i, off:off + b - t, l:r]).all()
        assert (lines.crop(ci, i).numpy() == ti[i, off:off + b - t, l:r]).all()
    assert (counts[:, 0] == np.asarray(ones)[:3]).all()
    assert (counts[:, 1] == np.asarray(ones_inv)[:3]).all()


@pytest.mark.parametrize('case', ['one_row', 'smaller_than_window',
                                  'page_edges', 'tall_600'])
def test_line_crops_match_golden_at_odd_shapes(case):
    if case == 'tall_600':
        gray = synth_page(640, 160, seed=9)[None]
        boxes, window = [[20, 620, 10, 150]], 101
    else:
        gray = np.stack([synth_page(90, 140, seed=s) for s in range(2)])
        window = 31
        boxes = {'one_row': [[40, 41, 10, 130], [0, 1, 0, 140]],
                 'smaller_than_window': [[30, 42, 50, 61], [5, 8, 3, 4]],
                 'page_edges': [[0, 25, 0, 140], [70, 90, 100, 140],
                                [0, 90, 130, 140]]}[case]
    boxes = np.array(boxes)
    pages = np.arange(len(boxes)) % len(gray)
    _golden_check(gray, boxes, pages, window)


def test_ragged_layout_and_bad_boxes():
    lines = RaggedLines([[2, 5, 1, 4], [0, 1, 0, 7]], [1, 0], 2, 6, 8, 'cpu')
    assert lines.sizes.tolist() == [9, 7]
    assert lines.offsets.tolist() == [0, 9, 16] and lines.total == 16
    assert lines.table.tolist() == [[2, 5, 1, 4, 1], [0, 1, 0, 7, 0]]
    for boxes, pages in (([[2, 2, 1, 4]], [0]), ([[2, 7, 1, 4]], [0]),
                         ([[2, 5, 1, 9]], [0]), ([[2, 5, 1, 4]], [2])):
        with pytest.raises(ValueError):
            RaggedLines(boxes, pages, 2, 6, 8, 'cpu')
    empty = RaggedLines.from_page_boxes([[], []], 6, 8, 'cpu')
    assert empty.n == 0 and empty.total == 0


# tests/test_pallas.py:176-213: overlapping boxes on page 0, page 2 has
# no lines at all
PASTE_BOXES = np.array([[20, 60, 100, 250],
                        [35, 80, 60, 220],       # overlaps the first
                        [70, 115, 5, 245],
                        [9, 40, 30, 200]])
PASTE_PAGES = np.array([0, 0, 1, 1])


def _paste_inputs():
    bsz, h, w = 3, 120, 250
    gray = np.stack([synth_page(h, w, seed=s) for s in range(bsz)])
    gmask = np.zeros((bsz, h, w), bool)
    gmask[:, 100:104, 10:50] = True
    return gray, gmask


@pytest.mark.parametrize('selector', [[1, 2, 0, 1], [2, 1, 1, 2],
                                      [0, 0, 0, 0]])
def test_paste_matches_scan_and_pallas_interpret(selector):
    selector = np.array(selector, np.int32)
    gray, gmask = _paste_inputs()
    bsz, h, w = gray.shape
    lines, ct, ci, _ = _port_lines(gray, PASTE_BOXES, PASTE_PAGES, 51)
    got = paste_lines(ct, ci, lines, selector, torch.from_numpy(gmask))
    got = got.numpy()

    boxes = PASTE_BOXES.T.astype(np.int32)
    pages = PASTE_PAGES.astype(np.int32)
    th, ti, _o, _oi = line_thresholds_pallas(gray, boxes, pages, 51, 0.1,
                                             interpret=True)
    th, ti = th[:4], ti[:4]                       # drop the GROUP padding
    ref = np.asarray(JD.paste_selected_crops(
        th, ti, jnp.asarray(boxes), jnp.asarray(pages),
        jnp.asarray(selector), jnp.asarray(gmask), bsz, h))
    assert (got == ref).all()
    plan = build_paste_plan(boxes, pages, selector, bsz)
    pallas = np.asarray(paste_crops_pallas(
        th, ti, *(jnp.asarray(plan[k]) for k in
                  ('li', 't', 'b', 'l', 'r', 'sel', 'gpage', 'gfirst')),
        jnp.asarray(gmask), interpret=True))
    assert (got == pallas).all()
    assert (got[2] == gmask[2]).all()             # the page with no lines
    if not selector.any():
        assert (got == gmask).all()


def test_paste_last_selected_line_wins():
    # two selected lines over one box: the later one's crop shows; an
    # unselected later line changes nothing
    gray = synth_page(60, 80, seed=4)[None]
    boxes = np.array([[10, 40, 10, 70], [10, 40, 10, 70], [10, 40, 10, 70]])
    lines, ct, ci, _ = _port_lines(gray, boxes, [0, 0, 0], 15)
    gmask = torch.zeros((1, 60, 80), dtype=torch.bool)
    got = paste_lines(ct, ci, lines, [1, 2, 0], gmask).numpy()[0]
    assert (got[10:40, 10:70] == lines.crop(ci, 1).numpy()).all()
    assert not got[:10].any() and not got[40:].any()
