"""The tilings of the port's Hopper kernels, emulated on the CPU with
their plain PyTorch versions.

A CUDA kernel runs only on a GPU (``chip_smoke.py`` holds each one
against its plain version there).  What the kernels add to the plain
arithmetic is a plan: which tile, strip or run of rows each CTA owns and
which halo it loads.  These tests compute each tile alone from its halo
with the plain versions, stitch the tiles, and assert equality with the
whole-page plain version and, through it, with the JAX package:

- B7 (``csrc/dwt97.cu``): tiles of a level's region with a halo of
  ``dwt97_cuda.HALO`` samples (and a halo one short goes wrong);
- K3 (``csrc/blur_sauvola.cu``): blur tiles with a halo of r, then
  Sauvola column strips and row runs with a halo of o-1 / u;
- K4 (``csrc/line_sauvola.cu``): wide lines split into column strips
  (``lines_cuda.line_strips``), the window still clamped to the line;
- K2's widest page (``denoise_cuda.max_width``).
"""

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu.codecs import jp2tpu as J
from archive_pdf_tools_tpu.mrc import decompose as JD
from archive_pdf_tools_tpu.ops import golden

from archive_pdf_tools_tpu_torch.codecs import jp2host as H
from archive_pdf_tools_tpu_torch.codecs.jp2tpu import capped_levels
from archive_pdf_tools_tpu_torch.ops import dwt97 as D
from archive_pdf_tools_tpu_torch.ops import dwt97_cuda as DC
from archive_pdf_tools_tpu_torch.ops import lines_cuda as LC
from archive_pdf_tools_tpu_torch.ops import threshold_cuda as TC
from archive_pdf_tools_tpu_torch.ops import denoise_cuda
from archive_pdf_tools_tpu_torch.ops.sauvola import (sauvola_counts,
                                                      sauvola_mask,
                                                      sauvola_sums,
                                                      sauvola_test)
from archive_pdf_tools_tpu_torch.ops.sigma import symmetric_index

from tests.test_kernels import synth_page

torch.set_num_threads(2)


# --- B7: the 9/7 DWT over tiles with halos -----------------------------------

def _spans(n, tile, halo):
    """DC.tiles with a halo of (left, right) samples."""
    return [(s, min(s + tile, n), max(s - halo[0], 0),
             min(s + tile + halo[1], n)) for s in range(0, n, tile)]


def dwt97_tiled(imgs, levels, base_delta, tile, halo=(DC.HALO, DC.HALO)):
    """``ops/dwt97.dwt97`` computed as the kernel tiles it: per level, each
    tile's loaded span lifted alone (vertical, then horizontal, as in
    ``_lift``) and its outputs stitched into the four bands."""
    inv = [float(np.float32(1.0 / m[5]))
           for m in H.band_layout(levels, float(base_delta))]
    out = []
    for comp in D.components(imgs):
        ll, details = comp, []
        for _ in range(levels):
            b, hh, ww = ll.shape
            lh, lw = (hh + 1) // 2, (ww + 1) // 2
            bands = [torch.full((b, rh, rw), float('nan'))
                     for rh, rw in ((lh, lw), (lh, ww - lw), (hh - lh, lw),
                                    (hh - lh, ww - lw))]
            for y0, y1, ys, ye in _spans(hh, tile[0], halo):
                for x0, x1, xs, xe in _spans(ww, tile[1], halo):
                    lo, hi = D._lift(ll[:, ys:ye, xs:xe], -2)
                    a = (y0 - ys) // 2
                    rows = (lo[:, a:a + (y1 - y0 + 1) // 2],
                            hi[:, a:a + (y1 - y0) // 2])
                    c, nl, nh = (x0 - xs) // 2, (x1 - x0 + 1) // 2, \
                        (x1 - x0) // 2
                    for py, r in enumerate(rows):
                        low, high = D._lift(r, -1)
                        n = r.shape[1]
                        for px, (part, cols) in enumerate(((low, nl),
                                                           (high, nh))):
                            bands[2 * py + px][:, y0 // 2:y0 // 2 + n,
                                               x0 // 2:x0 // 2 + cols] = \
                                part[:, :, c:c + cols]
            assert not any(bool(torch.isnan(t).any()) for t in bands)
            ll = bands[0]
            details.append(tuple(bands[1:]))
        allb = [ll] + [t for lvl in reversed(details) for t in lvl]
        out.append(tuple((t * s).to(torch.int32) for t, s in zip(allb, inv)))
    return tuple(out)


# (B, H, W), RGB, levels, output tile
DWT_TILE_CASES = [
    ((2, 45, 37), False, 1, (8, 6)), ((2, 45, 37), False, 3, (8, 6)),
    ((1, 64, 51), False, 5, (10, 12)), ((2, 33, 70), True, 2, (6, 8)),
    ((1, 97, 131), True, 4, (14, 10)), ((1, 5, 7), False, 3, (2, 2)),
    ((2, 120, 90), False, 5, DC.TILE), ((1, 21, 300), True, 5, (4, 16)),
]


@pytest.mark.parametrize('shape,rgb,levels,tile', DWT_TILE_CASES)
def test_dwt97_tiles_stitch_to_the_whole_transform(shape, rgb, levels, tile):
    lv = capped_levels(shape[1], shape[2], levels)
    rng = np.random.default_rng(shape[1] * 31 + levels)
    img = rng.integers(0, 256, shape + ((3,) if rgb else ()), dtype=np.uint8)
    whole = D.dwt97(torch.from_numpy(img), lv, 1 / 64)
    tiled = dwt97_tiled(torch.from_numpy(img), lv, 1 / 64, tile)
    xla = J._device_transform(img, lv, rgb, 1 / 64)
    for wc, tc, xc in zip(whole, tiled, xla):
        for k, (a, b, c) in enumerate(zip(wc, tc, xc)):
            assert torch.equal(a, b), k
            assert np.array_equal(b.numpy(), np.asarray(c)), k


@pytest.mark.parametrize('halo,exact', [((4, 3), True), ((2, 4), False),
                                        ((4, 2), False)])
def test_dwt97_halo_reach(halo, exact):
    """The lifts reach 4 samples to the left and 3 to the right: a halo
    of (4, 3) is exact, one of 2 on either side (a span must start on an
    even sample) is not."""
    img = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (1, 40, 44), dtype=np.uint8))
    whole = D.dwt97(img, 2, 1 / 64)
    tiled = dwt97_tiled(img, 2, 1 / 64, (8, 8), halo=halo)
    same = all(torch.equal(a, b) for a, b in zip(whole[0], tiled[0]))
    assert same == exact


def test_dwt97_tile_plan_covers_each_output_once():
    for n in (1, 2, 7, 56, 57, 120, 121, 3300, 47104):
        for tile in ((2, 4, 56, 120) if n < 200 else DC.TILE):
            spans = DC.tiles(n, tile)
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            for s, e, ls, le in spans:
                assert s % 2 == 0 and ls % 2 == 0 and 0 < e - s <= tile
            assert spans == _spans(n, tile, (DC.HALO, DC.HALO))
    assert DC.TILE[0] % 2 == 0 and DC.TILE[1] % 2 == 0 and DC.HALO >= 4


# --- K3: blur tiles, then Sauvola strips and runs -----------------------------

def _taps(b, r, seed):
    sig = np.random.default_rng(seed).uniform(0.8, 3.0, b)
    idx = np.arange(-r, r + 1)
    g = np.exp(-0.5 * idx[None] ** 2 / sig[:, None] ** 2)
    return torch.from_numpy((g / g.sum(1, keepdims=True)).astype(np.float32))


def blur_tiled(img, taps, tile):
    """``separable_blur`` as the kernel's blur launch tiles it: each tile
    loads its rows and columns extended by r (symmetric at the page's
    edges), runs the vertical then the horizontal MAC alone."""
    b, h, w = img.shape
    r = (taps.shape[1] - 1) // 2
    out = torch.empty_like(img)
    x = img.to(torch.float32)
    for y0 in range(0, h, tile[0]):
        y1 = min(y0 + tile[0], h)
        ridx = _sym(torch.arange(y0 - r, y1 + r), h)
        for x0 in range(0, w, tile[1]):
            x1 = min(x0 + tile[1], w)
            cidx = _sym(torch.arange(x0 - r, x1 + r), w)
            xp = x[:, ridx][:, :, cidx]
            v = TC.vertical_mac(xp, taps, y1 - y0)
            out[:, y0:y1, x0:x1] = TC.truncate_u8(
                TC.horizontal_mac(v, taps, x1 - x0))
    return out


def _sym(p, n):
    """The symmetric (edge-repeating) border index of csrc/blur_sauvola.cu's
    sym_index, for any p."""
    q = p % (2 * n)
    return torch.where(q < n, q, 2 * n - 1 - q)


def sauvola_walked(img, window, strip, run, k=0.34):
    """``sauvola_mask`` as the kernel's walk cuts the page: each CTA's
    strip and run of rows computed from only the columns and rows its
    windows reach (o-1 to the left and above, u to the right and below,
    clamped to the page), its count from the page's clamps."""
    b, h, w = img.shape
    o, u = (window + 1) // 2, window // 2
    cnt = sauvola_counts(h, w, window, window, 'cpu')
    out = torch.zeros(img.shape, dtype=torch.bool)
    for y0 in range(0, h, run):
        y1 = min(y0 + run, h)
        ya, yb = max(y0 - o + 1, 0), min(y1 - 1 + u, h - 1) + 1
        for c0 in range(0, w, strip):
            c1 = min(c0 + strip, w)
            xa, xb = max(c0 - o + 1, 0), min(c1 + u, w)
            s, s2 = sauvola_sums(img[:, ya:yb, xa:xb], window, window)
            sl = (slice(None), slice(y0 - ya, y1 - ya),
                  slice(c0 - xa, c1 - xa))
            out[:, y0:y1, c0:c1] = sauvola_test(
                img[:, y0:y1, c0:c1], s[sl], s2[sl], cnt[y0:y1, c0:c1], k)
    return out


# (B, H, W), blur radius, window, blur tile, walk columns, walk rows
K3_TILE_CASES = [
    ((2, 45, 61), 4, 25, (8, 16), 40, 7),
    ((1, 80, 150), 4, 101, (32, 128), 120, 33),
    ((2, 37, 90), 16, 25, (6, 20), 30, 5),
    ((1, 70, 130), 16, 101, (16, 32), 101, 64),
    ((1, 9, 200), 16, 25, (4, 50), 26, 1),     # a page shorter than 2r
    ((1, 64, 600), 4, 101, TC.BLUR_TILE, TC.WALK_COLS, TC.WALK_ROWS),
]


@pytest.mark.parametrize('shape,r,window,tile,cols,rows', K3_TILE_CASES)
def test_blur_sauvola_tiles_stitch_to_the_whole_page(shape, r, window, tile,
                                                     cols, rows):
    b, h, w = shape
    if h >= 30:
        img = np.stack([synth_page(h, w, seed=s, noise=25) for s in range(b)])
    else:
        img = np.random.default_rng(h).integers(0, 256, shape, np.uint8)
    img = torch.from_numpy(img)
    taps = _taps(b, r, seed=h + w)
    blurred = blur_tiled(img, taps, tile)
    assert torch.equal(blurred, TC.separable_blur(img, taps))
    strip, run = TC.sauvola_plan(window, cols, rows)
    assert strip + window - 1 == cols and run == rows
    got = sauvola_walked(blurred, window, strip, run)
    assert torch.equal(got, TC.blur_sauvola_plain(img, taps, window))
    assert 0 < got.float().mean() < 1
    # identity taps: the blur is the page, and the JAX package's Sauvola
    # of it agrees
    ident = torch.zeros((b, 2 * r + 1))
    ident[:, r] = 1.0
    jax_ref = np.asarray(JD.global_threshold(img.numpy(), window))
    assert torch.equal(blur_tiled(img, ident, tile), img)
    assert (sauvola_walked(img, window, strip, run).numpy() == jax_ref).all()


def test_sauvola_plan_halos_reach_the_window():
    for window in (1, 25, 101, 183, 255):
        o, u = (window + 1) // 2, window // 2
        strip, run = TC.sauvola_plan(window)
        assert strip >= 1 and run == TC.WALK_ROWS
        assert strip + (o - 1) + u == TC.WALK_COLS
    with pytest.raises(ValueError):
        TC.sauvola_plan(101, walk_cols=100)
    assert TC.MAX_WINDOW == 255 and not hasattr(TC, 'MAX_WIDTH')


# --- K4: wide lines in column strips ------------------------------------------

def lines_striped(gray, boxes, pages, window, max_width, k=0.1):
    """``line_thresholds_plain`` as the kernel cuts lines into strips
    (``line_strips``): each strip from its own columns plus its halo, the
    window clamped to the line; the ink counts added up strip by strip."""
    strips, loaded = LC.line_strips(boxes, window, max_width)
    assert loaded <= max_width
    lines = LC.RaggedLines(boxes, pages, *gray.shape, device='cpu')
    out_t = torch.full((lines.total,), 7, dtype=torch.uint8)
    out_i = out_t.clone()
    counts = torch.zeros((lines.n, 2), dtype=torch.int32)
    o, u = (window + 1) // 2, window // 2
    for i, c0, c1 in strips:
        t, b, l, r = (int(v) for v in lines.boxes[i])
        crop = gray[int(lines.pages[i]), t:b, l:r]
        cnt = sauvola_counts(b - t, r - l, window, window, 'cpu')
        xa, xb = max(c0 - o + 1, l) - l, min(c1 + u, r) - l
        assert xb - xa <= loaded
        for pol, (img, flat) in enumerate(((crop, out_t),
                                           (255 - crop, out_i))):
            s, s2 = sauvola_sums(img[:, xa:xb], window, window)
            sl = slice(c0 - l - xa, c1 - l - xa)
            m = sauvola_test(img[:, c0 - l:c1 - l], s[:, sl], s2[:, sl],
                             cnt[:, c0 - l:c1 - l], k)
            lines.crop(flat, i)[:, c0 - l:c1 - l] = m
            counts[i, pol] += int(m.sum())
    return lines, strips, out_t, out_i, counts


@pytest.mark.parametrize('window,max_width', [(31, 40), (31, 31), (51, 90),
                                              (15, 16)])
def test_line_strips_stitch_to_whole_lines(window, max_width):
    gray = torch.from_numpy(np.stack([synth_page(90, 300, seed=s)
                                      for s in range(2)]))
    boxes = np.array([[10, 40, 5, 295], [30, 31, 0, 300], [50, 90, 100, 139],
                      [0, 90, 280, 300], [60, 75, 7, 7 + max_width],
                      [20, 70, 40, 41 + max_width]])
    pages = np.array([0, 1, 0, 1, 1, 0])
    lines, strips, ct, ci, counts = lines_striped(gray, boxes, pages, window,
                                                  max_width)
    ref = LC.line_thresholds_plain(gray, lines, window)
    assert torch.equal(ct, ref[0]) and torch.equal(ci, ref[1])
    assert torch.equal(counts, ref[2])
    per_line = np.bincount(strips[:, 0], minlength=len(boxes))
    widths = boxes[:, 3] - boxes[:, 2]
    assert ((per_line > 1) == (widths > max_width)).all()
    assert per_line[4] == 1 and per_line[5] > 1
    for i, (t, b, l, r) in enumerate(boxes):
        g = gray[pages[i], t:b, l:r].numpy()
        assert (lines.crop(ct, i).numpy()
                == golden.sauvola_mask_ref(g, window, window, 0.1)).all()


def test_line_of_20000_columns_matches_golden():
    """A line far wider than one CTA takes (MAX_LINE_WIDTH), cut as the
    kernel cuts it, held to the reference oracle on its crop."""
    rng = np.random.default_rng(11)
    w = 20000
    page = np.clip(rng.normal(200, 30, (1, 20, w)), 0, 255).astype(np.uint8)
    for x in range(10, w - 20, 37):
        page[0, 5:15, x:x + 6] = rng.integers(20, 90)
    gray = torch.from_numpy(page)
    boxes, pages = np.array([[4, 16, 0, w]]), np.array([0])
    lines, strips, ct, ci, counts = lines_striped(gray, boxes, pages, 101,
                                                  LC.MAX_LINE_WIDTH)
    assert len(strips) == -(-w // (LC.MAX_LINE_WIDTH - 100))
    crop = page[0, 4:16]
    ref = golden.sauvola_mask_ref(crop, 101, 101, 0.1)
    refi = golden.sauvola_mask_ref(255 - crop, 101, 101, 0.1)
    assert (lines.crop(ct, 0).numpy() == ref).all()
    assert (lines.crop(ci, 0).numpy() == refi).all()
    assert counts.tolist() == [[int(ref.sum()), int(refi.sum())]]


@pytest.mark.parametrize('window', [1, 31, 101, 255])
def test_line_strip_plan_covers_each_column_once(window):
    o, u = (window + 1) // 2, window // 2
    boxes = np.array([[0, 5, 0, 2550], [3, 9, 17, LC.MAX_LINE_WIDTH + 17],
                      [0, 2, 5, LC.MAX_LINE_WIDTH + 6], [1, 4, 0, 47104],
                      [0, 12, 100, 20100]])
    strips, loaded = LC.line_strips(boxes, window)
    assert loaded <= LC.MAX_LINE_WIDTH
    for i, (t, b, l, r) in enumerate(boxes):
        mine = strips[strips[:, 0] == i]
        assert mine[0, 1] == l and mine[-1, 2] == r
        assert (mine[1:, 1] == mine[:-1, 2]).all() and (mine[:, 2] >
                                                        mine[:, 1]).all()
        if r - l <= LC.MAX_LINE_WIDTH:
            assert len(mine) == 1             # today's path: one CTA a line
        for _, c0, c1 in mine:
            lo, hi = max(c0 - o + 1, l), min(c1 + u, r)
            # the halo reaches every window of the strip's columns
            assert lo == max(c0 - (o - 1), l) and hi == min(c1 - 1 + u + 1, r)
            assert hi - lo <= LC.MAX_LINE_WIDTH
    with pytest.raises(ValueError):
        LC.line_strips(boxes, 101, max_width=100)


# --- K2: the widest page ------------------------------------------------------

def test_despeckle_takes_the_widest_pages():
    assert denoise_cuda.max_width() >= 47104
    assert denoise_cuda.walk_layout(2550) == (96, 1)        # the main path
    assert denoise_cuda.walk_layout(32768) == (1024, 1)
    assert denoise_cuda.walk_layout(32769) == (544, 2)
    assert denoise_cuda.walk_layout(47104) == (736, 2)
    assert denoise_cuda.walk_layout(denoise_cuda.max_width()) == (1024, 2)
    for w in (1, 31, 33, 2550, 32768, 32769, 47104, 65536):
        threads, wpt = denoise_cuda.walk_layout(w)
        assert threads % 32 == 0 and threads <= denoise_cuda.MAX_THREADS
        assert 32 * wpt * threads >= w > 32 * wpt * (threads - 32)
