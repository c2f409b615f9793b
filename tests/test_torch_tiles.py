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
- K4 (``csrc/line_sauvola.cu``): lines cut into units of a row segment
  and a column tile (``lines_cuda.line_units``), each unit's rows walked
  in runs that share one vertical window (``lines_cuda.window_runs``),
  the window still clamped to the line;
- K5 (``csrc/paste.cu``): the paste tile by tile, the lines of a page
  listed in document order (``paste_cuda.paste_plan``) and the selected
  ones pasted;
- K1 (``csrc/optimise.cu``) and K2 (``csrc/despeckle.cu``) past one CTA:
  column strips run as a wavefront, handing over only halos (a halo one
  short goes wrong), and K2's layout.

Every comparison here is exact.
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
from archive_pdf_tools_tpu_torch.ops import denoise_cuda, paste_cuda
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


# --- K4: lines in units of a row segment x a column tile, rows in runs ------

def ink_limits(s, q, cnt, k):
    """The kernel's per-column form of the ink test of a run: for each
    column (its window sums s, q and count), how many pixel values from 0
    up are ink.  The ink values must be a prefix of 0..255 (the test is
    monotone in the pixel), which is checked here."""
    px = torch.arange(256, dtype=torch.uint8)[:, None]
    ink = sauvola_test(px, s, q, cnt, k).to(torch.int64)    # (256, cols)
    assert (ink[:-1] >= ink[1:]).all()
    return ink.sum(0)


def lines_in_units(gray, boxes, pages, window, tile=LC.TILE_COLS,
                   seg=LC.SEG_ROWS, k=0.1):
    """``line_thresholds_plain`` as the kernel cuts lines into units
    (``line_units``) and walks each unit's rows in runs that share one
    vertical window (``window_runs``): per run, the column sums of its
    window over the unit's columns plus halo only, their prefix, each
    column's ink limit (``ink_limits``) and every row of the run
    thresholded against it; the inverse crop's sums derived from S and Q;
    the ink counts added unit by unit."""
    units, (tiles, segs) = LC.line_units(boxes, window, tile, seg)
    lines = LC.RaggedLines(boxes, pages, *gray.shape, device='cpu')
    out_t = torch.full((lines.total,), 7, dtype=torch.uint8)
    out_i = out_t.clone()
    counts = torch.zeros((lines.n, 2), dtype=torch.int32)
    o, u = (window + 1) // 2, window // 2
    for i, y0, y1, c0, c1 in units:
        t, b, l, r = (int(v) for v in lines.boxes[i])
        crop = gray[int(lines.pages[i]), t:b, l:r].to(torch.int64)
        lc0, lc1 = max(c0 - o + 1, l), min(c1 + u, r)
        assert lc1 - lc0 <= tile + window - 1
        xs = torch.arange(c0, c1)
        a = (xs - o + 1).clamp(min=l) - lc0
        e = (xs + u).clamp(max=r - 1) + 1 - lc0
        for ya, yb, lo, hi in LC.window_runs(t, b, y0, y1, window):
            rows = crop[lo - t:hi - t + 1, lc0 - l:lc1 - l]
            ps = torch.cat([torch.zeros(1, dtype=torch.int64),
                            rows.sum(0).cumsum(0)])
            pq = torch.cat([torch.zeros(1, dtype=torch.int64),
                            (rows * rows).sum(0).cumsum(0)])
            sw, qw = (ps[e] - ps[a])[None], (pq[e] - pq[a])[None]
            cnt = ((hi - lo + 1) * (e - a))[None]
            img = crop[ya - t:yb - t, c0 - l:c1 - l]
            for pol, (px, s, q, flat) in enumerate((
                    (img, sw, qw, out_t),
                    (255 - img, 255 * cnt - sw, 65025 * cnt - 510 * sw + qw,
                     out_i))):
                m = px < ink_limits(s, q, cnt, k)[None]
                lines.crop(flat, i)[ya - t:yb - t, c0 - l:c1 - l] = m
                counts[i, pol] += int(m.sum())
    return lines, units, out_t, out_i, counts


@pytest.mark.parametrize('window,max_width', [(31, 40), (31, 31), (51, 90),
                                              (15, 16)])
def test_line_strips_stitch_to_whole_lines(window, max_width):
    """Column tiles of max_width output columns and row segments of 7
    rows: stitched, == the whole-line plain version and == golden."""
    gray = torch.from_numpy(np.stack([synth_page(90, 300, seed=s)
                                      for s in range(2)]))
    boxes = np.array([[10, 40, 5, 295], [30, 31, 0, 300], [50, 90, 100, 139],
                      [0, 90, 280, 300], [60, 75, 7, 7 + max_width],
                      [20, 70, 40, 41 + max_width]])
    pages = np.array([0, 1, 0, 1, 1, 0])
    lines, units, ct, ci, counts = lines_in_units(gray, boxes, pages, window,
                                                  max_width, seg=7)
    ref = LC.line_thresholds_plain(gray, lines, window)
    assert torch.equal(ct, ref[0]) and torch.equal(ci, ref[1])
    assert torch.equal(counts, ref[2])
    strips, _ = LC.line_strips(boxes, window, max_width)
    per_line = np.bincount(strips[:, 0], minlength=len(boxes))
    widths = boxes[:, 3] - boxes[:, 2]
    assert (per_line == -(-widths // max_width)).all()
    assert per_line[4] == 1 and per_line[5] == 2
    for i, (t, b, l, r) in enumerate(boxes):
        g = gray[pages[i], t:b, l:r].numpy()
        assert (lines.crop(ct, i).numpy()
                == golden.sauvola_mask_ref(g, window, window, 0.1)).all()


def test_line_of_20000_columns_matches_golden():
    """A line far wider than one unit, cut as the kernel cuts it (tiles of
    ``TILE_COLS``), held to the reference oracle on its crop."""
    rng = np.random.default_rng(11)
    w = 20000
    page = np.clip(rng.normal(200, 30, (1, 20, w)), 0, 255).astype(np.uint8)
    for x in range(10, w - 20, 37):
        page[0, 5:15, x:x + 6] = rng.integers(20, 90)
    gray = torch.from_numpy(page)
    boxes, pages = np.array([[4, 16, 0, w]]), np.array([0])
    lines, units, ct, ci, counts = lines_in_units(gray, boxes, pages, 101)
    assert len(units) == -(-w // LC.TILE_COLS)
    crop = page[0, 4:16]
    ref = golden.sauvola_mask_ref(crop, 101, 101, 0.1)
    refi = golden.sauvola_mask_ref(255 - crop, 101, 101, 0.1)
    assert (lines.crop(ct, 0).numpy() == ref).all()
    assert (lines.crop(ci, 0).numpy() == refi).all()
    assert counts.tolist() == [[int(ref.sum()), int(refi.sum())]]


@pytest.mark.parametrize('window', [1, 31, 101, 255])
def test_line_strip_plan_covers_each_column_once(window):
    """Every line, of any width and height, is cut into column tiles and
    row segments that cover each of its pixels once; a tile's loaded
    columns (its own plus the window's reach, clamped to the line) fit
    the kernel's three column sums a thread."""
    o, u = (window + 1) // 2, window // 2
    boxes = np.array([[0, 5, 0, 2550], [3, 9, 17, 14529], [0, 2, 5, 14518],
                      [1, 4, 0, 47104], [0, 12, 100, 20100],
                      [0, 300, 7, 520], [2, 66, 0, 120000]])
    strips, loaded = LC.line_strips(boxes, window)
    assert loaded <= LC.TILE_COLS + window - 1 <= 3 * 256
    units, (tiles, segs) = LC.line_units(boxes, window)
    assert tiles == -(-120000 // LC.TILE_COLS) and segs == -(-300 //
                                                             LC.SEG_ROWS)
    for i, (t, b, l, r) in enumerate(boxes):
        mine = strips[strips[:, 0] == i]
        assert mine[0, 1] == l and mine[-1, 2] == r
        assert (mine[1:, 1] == mine[:-1, 2]).all() and (mine[:, 2] >
                                                        mine[:, 1]).all()
        assert len(mine) == -(-(r - l) // LC.TILE_COLS)
        for _, c0, c1 in mine:
            lo, hi = max(c0 - o + 1, l), min(c1 + u, r)
            # the halo reaches every window of the tile's columns
            assert lo == max(c0 - (o - 1), l) and hi == min(c1 - 1 + u + 1, r)
        cover = np.zeros((b - t, r - l), np.int32)
        for _, y0, y1, c0, c1 in units[units[:, 0] == i]:
            cover[y0 - t:y1 - t, c0 - l:c1 - l] += 1
            assert 0 < y1 - y0 <= LC.SEG_ROWS
        assert (cover == 1).all()


@pytest.mark.parametrize('window', [31, 101, 255])
def test_distinct_window_count(window):
    """The distinct vertical windows of a line of h rows: the closed form,
    a brute count of its rows' (top, bottom) pairs, and the runs the
    kernel walks, for h = 1..300."""
    o, u = (window + 1) // 2, window // 2
    for h in range(1, 301):
        t, b = 5, 5 + h
        pairs = {(max(y - o + 1, t), min(y + u, b - 1)) for y in range(t, b)}
        runs = LC.window_runs(t, b, t, b, window)
        assert LC.distinct_windows(h, window) == len(pairs) == len(runs)
        assert runs[0][0] == t and runs[-1][1] == b
        assert all(p[1] == q[0] for p, q in zip(runs, runs[1:]))
        for ya, yb, lo, hi in runs:
            assert all((max(y - o + 1, t), min(y + u, b - 1)) == (lo, hi)
                       for y in range(ya, yb))
    assert LC.distinct_windows(51, 101) == 1
    assert LC.distinct_windows(52, 101) == 3


def test_line_units_match_golden_and_pallas_interpret():
    """Lines of 1-60 rows and one of 100, cut into units of 16 rows x 48
    columns and walked in window runs (1, 1 and 3 distinct windows on the
    three short lines at window 51, 100 on the tall one), stitched: ==
    golden
    and == the JAX package's Pallas kernel in interpret mode."""
    from archive_pdf_tools_tpu.ops.lines_pallas import line_thresholds_pallas
    gray = np.stack([synth_page(140, 200, seed=s) for s in range(2)])
    boxes = np.array([[3, 4, 10, 190], [10, 36, 0, 120], [40, 67, 30, 200],
                      [60, 111, 5, 99], [80, 140, 100, 150],
                      [8, 108, 150, 200]])
    pages = np.array([1, 0, 1, 0, 0, 1])
    window = 51
    lines, units, ct, ci, counts = lines_in_units(
        torch.from_numpy(gray), boxes, pages, window, tile=48, seg=16)
    runs = [len(LC.window_runs(t, b, t, b, window)) for t, b, _l, _r in boxes]
    assert runs == [LC.distinct_windows(b - t, window)
                    for t, b, _l, _r in boxes]
    assert runs[:3] == [1, 1, 3] and runs[5] > 60
    th, ti, ones, ones_inv = line_thresholds_pallas(
        gray, boxes.T.astype(np.int32), pages.astype(np.int32), window, 0.1,
        interpret=True)
    th, ti = np.asarray(th), np.asarray(ti)
    for i, (t, b, l, r) in enumerate(boxes):
        crop = gray[pages[i], t:b, l:r]
        ref = golden.sauvola_mask_ref(crop, window, window, 0.1)
        refi = golden.sauvola_mask_ref(255 - crop, window, window, 0.1)
        assert (lines.crop(ct, i).numpy() == ref).all(), i
        assert (lines.crop(ci, i).numpy() == refi).all(), i
        off = t % 8           # Pallas crop rows are 8-aligned
        assert (lines.crop(ct, i).numpy() == th[i, off:off + b - t, l:r]).all()
        assert (lines.crop(ci, i).numpy() == ti[i, off:off + b - t, l:r]).all()
    assert (counts.numpy()[:, 0] == np.asarray(ones)[:len(boxes)]).all()
    assert (counts.numpy()[:, 1] == np.asarray(ones_inv)[:len(boxes)]).all()


# --- K5: the paste in tiles, lines listed per page in document order --------

def _plan(plan, batch):
    """``paste_plan`` read back: the page starts and, per line, (t, b, l,
    r, crop offset, line index)."""
    plan = np.asarray(plan)
    head = -(-(batch + 1) // 4) * 4
    recs = plan[head:].view(np.uint32).astype(np.int64).reshape(-1, 8)
    return plan[:batch + 1], [(int(t), int(b), int(l), int(r),
                               int(lo | hi << 32), int(i))
                              for t, b, l, r, lo, hi, i, _ in recs]


def paste_tiled(ct, ci, lines, selector, gmask, tile=(32, 512)):
    """``paste_lines_plain`` as the kernel tiles the page: per tile, the
    lines of its page from ``lines.paste_plan`` (in document order) that
    are selected and meet it, each clipped to the tile and overwriting it
    in turn, then the global mask OR-ed in."""
    b, h, w = gmask.shape
    starts, recs = _plan(lines.paste_plan, b)
    out = torch.zeros((b, h, w), dtype=torch.bool)
    for p in range(b):
        mine = recs[starts[p]:starts[p + 1]]
        for y0 in range(0, h, tile[0]):
            y1 = min(y0 + tile[0], h)
            for x0 in range(0, w, tile[1]):
                x1 = min(x0 + tile[1], w)
                buf = torch.zeros((y1 - y0, x1 - x0), dtype=torch.uint8)
                for t, bb, l, r, off, i in mine:
                    if selector[i] == 0:
                        continue
                    ya, yb = max(t, y0), min(bb, y1)
                    xa, xb = max(l, x0), min(r, x1)
                    if ya >= yb or xa >= xb:
                        continue
                    src = ci if selector[i] == 2 else ct
                    crop = src[off:off + (bb - t) * (r - l)].reshape(
                        bb - t, r - l)
                    buf[ya - y0:yb - y0, xa - x0:xb - x0] = \
                        crop[ya - t:yb - t, xa - l:xb - l]
                out[p, y0:y1, x0:x1] = (buf != 0) | gmask[p, y0:y1, x0:x1]
    return out


# overlapping boxes whose lines are not sorted by page; page 3 has none
TILE_BOXES = np.array([[20, 60, 100, 250], [0, 45, 0, 90], [35, 80, 60, 220],
                       [70, 115, 5, 245], [30, 70, 80, 180], [9, 40, 30, 200],
                       [50, 119, 0, 250], [2, 12, 240, 250]])
TILE_PAGES = np.array([0, 2, 0, 1, 0, 1, 2, 0])


@pytest.mark.parametrize('selector,tile', [
    ([1, 2, 1, 0, 2, 1, 1, 2], (32, 512)), ([2, 1, 2, 1, 1, 2, 0, 1], (8, 48)),
    ([1, 1, 1, 1, 1, 1, 1, 1], (5, 17)), ([0, 0, 0, 0, 0, 0, 0, 0], (8, 48))])
def test_paste_tiles_match_scan_and_pallas_interpret(selector, tile):
    from archive_pdf_tools_tpu.ops.lines_pallas import line_thresholds_pallas
    from archive_pdf_tools_tpu.ops.paste_pallas import (build_paste_plan,
                                                        paste_crops_pallas)
    import jax.numpy as jnp
    selector = np.array(selector, np.int32)
    bsz, h, w = 4, 120, 250
    gray = np.stack([synth_page(h, w, seed=s) for s in range(bsz)])
    gmask = np.zeros((bsz, h, w), bool)
    gmask[:, 100:104, 10:50] = True
    lines = LC.RaggedLines(TILE_BOXES, TILE_PAGES, bsz, h, w, device='cpu')
    ct, ci, _ = LC.line_thresholds_plain(torch.from_numpy(gray), lines, 51)
    got = paste_tiled(ct, ci, lines, selector, torch.from_numpy(gmask), tile)
    scan = paste_cuda.paste_lines_plain(ct, ci, lines, selector,
                                        torch.from_numpy(gmask))
    assert torch.equal(got, scan)
    boxes = TILE_BOXES.T.astype(np.int32)
    th, ti, _o, _oi = line_thresholds_pallas(
        gray, boxes, TILE_PAGES.astype(np.int32), 51, 0.1, interpret=True)
    plan = build_paste_plan(boxes, TILE_PAGES.astype(np.int32), selector, bsz)
    pallas = np.asarray(paste_crops_pallas(
        th[:len(selector)], ti[:len(selector)],
        *(jnp.asarray(plan[k]) for k in
          ('li', 't', 'b', 'l', 'r', 'sel', 'gpage', 'gfirst')),
        jnp.asarray(gmask), interpret=True))
    assert (got.numpy() == pallas).all()
    assert (got.numpy()[3] == gmask[3]).all()


def test_paste_plan_lists_each_page_in_document_order():
    lines = LC.RaggedLines(TILE_BOXES, TILE_PAGES, 4, 120, 250, device='cpu')
    plan = lines.paste_plan.numpy()
    assert plan.dtype == np.int32 and len(plan) == 8 + 8 * 8
    starts, recs = _plan(plan, 4)
    assert starts.tolist() == [0, 4, 6, 8, 8]
    order = [0, 2, 4, 7, 3, 5, 1, 6]
    assert [r[:4] for r in recs] == [tuple(TILE_BOXES[i]) for i in order]
    assert [r[4] for r in recs] == [int(lines.offsets[i]) for i in order]
    assert [r[5] for r in recs] == order
    empty = LC.RaggedLines([], [], 3, 120, 250, device='cpu')
    assert empty.paste_plan.numpy().tolist() == [0] * 4
    # a crop offset past 2^32 keeps its high word (no crop is allocated)
    huge = LC.RaggedLines([[0, 70000, 0, 70000], [5, 9, 3, 8]], [0, 0], 1,
                          70000, 70000, device='cpu')
    assert _plan(huge.paste_plan, 1)[1][1][4:] == (70000 * 70000, 1)


# --- K1: the wavefront of column strips ----------------------------------------

def _box_sums(a, n):
    """Sums of a (B, H, W, C) over rows [y-n, y+n) x cols [x-n, x+n),
    clamped to the page."""
    b, h, w, c = a.shape
    p = np.zeros((b, h + 1, w + 1, c), np.int64)
    p[:, 1:, 1:] = a.cumsum(1).cumsum(2)
    ya, yb = np.clip(np.arange(h) - n, 0, h), np.clip(np.arange(h) + n, 0, h)
    xa, xb = np.clip(np.arange(w) - n, 0, w), np.clip(np.arange(w) + n, 0, w)
    return (p[:, yb][:, :, xb] - p[:, ya][:, :, xb] - p[:, yb][:, :, xa]
            + p[:, ya][:, :, xa])


def optimise_wavefront(mask, img, n, strip, halo):
    """``ops/optimise.py`` as the wavefront cuts a row: the FIR sums of
    the whole page (the pre-pass), then row by row, strip by strip, each
    strip's IIR sums from only its own colI and the ``halo`` columns of
    colI its left neighbour hands over after the row above."""
    gray = img.ndim == 3
    x = (img[..., None] if gray else img).astype(np.int64)
    m = mask[..., None].astype(np.int64)
    b, h, w, c = x.shape
    fir_val, fir_cnt = _box_sums(x * m, n), _box_sums(m, n)
    out = np.zeros_like(x)
    col_i = np.zeros((b, w, c), np.int64)
    for y in range(h):
        for xs in range(0, w, strip):
            xe = min(xs + strip, w)
            seen = np.zeros_like(col_i)
            lo = max(xs - halo, 0)
            seen[:, lo:xe] = col_i[:, lo:xe]
            pref = np.concatenate([np.zeros((b, 1, c), np.int64),
                                   seen.cumsum(1)], 1)
            cols = np.arange(xs, xe)
            a = np.maximum(cols - n, 0)
            iir = pref[:, cols] - pref[:, a]
            cnt = fir_cnt[:, y, xs:xe] + min(y, n) * (cols - a)[None, :, None]
            val = fir_val[:, y, xs:xe] + iir
            filled = np.where(cnt > 0, val // np.maximum(cnt, 1), 0)
            out[:, y, xs:xe] = np.where(m[:, y, xs:xe] > 0, x[:, y, xs:xe],
                                        filled)
        col_i += out[:, y]
        if y >= n:
            col_i -= out[:, y - n]
    out = out.astype(np.uint8)
    return out[..., 0] if gray else out


@pytest.mark.parametrize('n,c,strip', [(1, 1, 16), (3, 1, 23), (3, 3, 40),
                                       (10, 1, 40), (10, 3, 31),
                                       (22, 1, 40), (22, 3, 37)])
def test_optimise_wavefront_strips_match_jax(n, c, strip):
    """Strips of 16-40 columns with a halo of n, stitched row by row in
    wavefront order: == the JAX package's optimise; a halo of n-1 is
    not."""
    from archive_pdf_tools_tpu.ops.optimise import optimise as jax_optimise
    rng = np.random.default_rng(n * 10 + c)
    h, w = 30, 130
    mask = rng.random((2, h, w)) < 0.3
    img = rng.integers(0, 256, (2, h, w) + ((c,) if c > 1 else ()),
                       dtype=np.uint8)
    ref = np.asarray(jax_optimise(mask, img, n))
    assert (optimise_wavefront(mask, img, n, strip, n) == ref).all()
    assert not (optimise_wavefront(mask, img, n, strip, n - 1) == ref).all()


# --- K2: the wavefront of column strips ----------------------------------------

def despeckle_strips(mask, strip, halo=2, mincnt=4, state=True):
    """The exact despeckle (n = 2) as the wavefront cuts a row: strip by
    strip, each from its start state (the final bits of the two columns
    left of it in this row, from its left neighbour) and the final rows
    y-1 and y-2 over its own columns plus ``halo`` on each side; the
    original rows are inputs."""
    m = np.asarray(mask).astype(np.int64)
    f = np.zeros_like(m)
    b, h, w = m.shape
    for p in range(b):
        for y in range(h):
            for xs in range(0, w, strip):
                xe = min(xs + strip, w)
                top = np.zeros((2, w + 4), np.int64)   # 2 zero columns a side
                lo, hi = max(xs - halo, 0), min(xe + halo, w)
                if y >= 2:
                    top[:, lo + 2:hi + 2] = f[p, y - 2:y, lo:hi]
                p1 = f[p, y, xs - 1] if xs >= 1 and state else 0
                p2 = f[p, y, xs - 2] if xs >= 2 and state else 0
                for x in range(xs, xe):
                    v = m[p, y, x]
                    if v and 2 <= y < h - 2 and 2 <= x < w - 2:
                        cnt = (top[:, x:x + 5].sum()
                               + m[p, y + 1:y + 3, x - 2:x + 3].sum()
                               + m[p, y, x + 1:x + 3].sum() + p1 + p2)
                        v = int(cnt >= mincnt)
                    f[p, y, x] = v
                    p1, p2 = v, p1
    return f.astype(bool)


@pytest.mark.parametrize('strip,ink', [(32, 0.5), (17, 0.3), (40, 0.7),
                                       (5, 0.5)])
def test_despeckle_wavefront_strips_match_golden(strip, ink):
    """Strips handing over their end state and final-row edge columns:
    == golden's despeckle and == the JAX package's."""
    from archive_pdf_tools_tpu.ops.denoise import (
        fast_mask_denoise_exact as jax_denoise)
    mask = np.random.default_rng(strip).random((2, 24, 96)) < ink
    ref = np.stack([golden.fast_mask_denoise_ref(mk, 4, 2) for mk in mask])
    got = despeckle_strips(mask, strip)
    assert (got == ref).all()
    assert (got == np.asarray(jax_denoise(mask, 4, 2))).all()


def test_despeckle_wavefront_needs_both_hand_overs():
    """Strips of 4 columns: a halo of one final-row column, or a start
    state not taken from the left strip, goes wrong."""
    rng = np.random.default_rng(8)
    mask = rng.random((3, 24, 64)) < 0.4
    ref = np.stack([golden.fast_mask_denoise_ref(mk, 4, 2) for mk in mask])
    assert (despeckle_strips(mask, 4) == ref).all()
    assert not (despeckle_strips(mask, 4, halo=1) == ref).all()
    assert not (despeckle_strips(mask, 4, state=False) == ref).all()


# --- K2: the widest page ------------------------------------------------------

def test_despeckle_takes_the_widest_pages():
    assert denoise_cuda.max_width() >= 47104
    assert denoise_cuda.walk_layout(2550) == (96, 1)        # the main path
    assert denoise_cuda.walk_layout(32768) == (1024, 1)
    assert denoise_cuda.walk_layout(32769) == (544, 2)
    assert denoise_cuda.walk_layout(47104) == (736, 2)
    assert denoise_cuda.walk_layout(denoise_cuda.max_width()) == (1024, 2)
    # past one CTA: strips of at most 1,024 words, one word a thread
    assert denoise_cuda.strips(65536) == 1
    assert denoise_cuda.strips(65537) == 3
    assert denoise_cuda.walk_layout(65537) == (704, 1)
    assert denoise_cuda.strips(120000) == 4
    assert denoise_cuda.walk_layout(120000) == (960, 1)
    for w in (1, 31, 33, 2550, 32768, 32769, 47104, 65536, 65537, 120000,
              10 ** 6):
        threads, wpt = denoise_cuda.walk_layout(w)
        k = denoise_cuda.strips(w)
        assert threads % 32 == 0 and threads <= denoise_cuda.MAX_THREADS
        # the strips cover each column once, the last one not empty
        assert 32 * wpt * threads * k >= w > 32 * wpt * threads * (k - 1)
        if k == 1:
            assert 32 * wpt * threads >= w > 32 * wpt * (threads - 32)
