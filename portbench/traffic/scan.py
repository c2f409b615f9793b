# Frozen copy of tests/scanfix.py (synth_scan and its helpers), verbatim
# below this header.  The benchmark's pages come from this copy, so a
# change to the test fixture never changes the benchmark's traffic.
"""High-fidelity synthetic scanned-page generator (VERDICT r1 #10).

The round-1 corpus was flat-gray rectangles plus white noise; the
reference's heuristics (line-polarity selection, noise-adaptive blur,
despeckle) were tuned on real book scans.  This generator reproduces
the structures those heuristics key off:

  * paper: low-frequency mottled texture with edge vignetting, not a
    constant level;
  * text: pseudo-glyph lines with per-glyph stroke structure, kerning
    jitter, variable stroke width, a slowly varying baseline (skew +
    sine wobble) — so hOCR line boxes are imperfect like real OCR;
  * bleed-through: faint mirrored text from the verso side;
  * figures: a halftone region (ordered-dither dots of a gradient) the
    mask should mostly NOT capture;
  * inverted regions (dark header band with light text) exercising the
    dual-threshold polarity heuristic;
  * sensor noise: gaussian + a sprinkle of dark specks (dust).

Pages come with matching hOCR word data; both the pixel image and the
word boxes are deterministic in the seed.
"""

import numpy as np
from scipy import ndimage


def _glyph(rng, gh, gw):
    """A connected pseudo-glyph: vertical/horizontal stroke skeleton
    dilated by a 2x2 kernel."""
    g = np.zeros((gh, gw), bool)
    n_strokes = int(rng.integers(2, 5))
    for _ in range(n_strokes):
        if rng.random() < 0.5:
            x = int(rng.integers(0, gw))
            y0, y1 = sorted(rng.integers(0, gh, 2))
            g[y0:y1 + 1, x] = True
        else:
            y = int(rng.integers(0, gh))
            x0, x1 = sorted(rng.integers(0, gw, 2))
            g[y, x0:x1 + 1] = True
    return ndimage.binary_dilation(g, np.ones((2, 2), bool))


_ATLAS_CACHE = {}


def _glyph_atlas(glyph_h, n=48, seed=20260820):
    """Shared letterform atlas (VERDICT r4 weak #5: the unique-stroke
    corpus is adversarial to JBIG2 symbol coding, which real book scans
    reward).  Fixed seed -> every page of a 'book' shares the same
    letterforms, like a font; instances still land at different phases
    and under different noise, as on a real scan."""
    key = (glyph_h, n, seed)
    if key not in _ATLAS_CACHE:
        rng = np.random.default_rng(seed)
        _ATLAS_CACHE[key] = [
            _glyph(rng, glyph_h,
                   int(rng.integers(glyph_h // 2, glyph_h)))
            for _ in range(n)]
    return _ATLAS_CACHE[key]


def synth_scan(h=600, w=440, seed=0, dpi=150,
               bleed=True, halftone=True, inverted_band=True,
               noise_sigma=9.0, fast_paper=False, repeat_glyphs=False):
    """Returns (uint8 page, word_data) shaped like archive-hocr-tools
    output (one paragraph, many lines).

    fast_paper: synthesize the low-frequency paper mottle at 1/8 scale
    and upsample — full-page-size corpora (3300x2550 bench pages) would
    otherwise spend tens of seconds in one huge gaussian_filter.  Still
    deterministic in the seed (different draws than fast_paper=False,
    so existing test fixtures are untouched).

    repeat_glyphs: draw from a fixed shared letterform atlas
    (Zipf-skewed sampling) instead of unique strokes per glyph — the
    corpus arm where JBIG2 symbol coding can win (VERDICT r4 #7)."""
    rng = np.random.default_rng(seed)

    # --- paper -------------------------------------------------------
    base = 228.0 + 10.0 * rng.random()
    if fast_paper:
        hs, ws = h // 8 + 2, w // 8 + 2
        small = ndimage.gaussian_filter(
            rng.normal(0, 1, (hs, ws)), sigma=max(1, h // 192))
        mottle = ndimage.zoom(small, 8, order=1)[:h, :w]
    else:
        mottle = ndimage.gaussian_filter(
            rng.normal(0, 1, (h, w)), sigma=max(8, h // 24))
    mottle *= 12.0 / max(mottle.std(), 1e-6)
    yy, xx = np.mgrid[0:h, 0:w]
    vign = 8.0 * (((yy / h - 0.5) ** 2 + (xx / w - 0.5) ** 2) * 2.0)
    page = base + mottle - vign

    ink_layer = np.zeros((h, w), np.float32)   # 0..1 coverage
    lines_meta = []

    # --- text block --------------------------------------------------
    glyph_h = max(10, int(dpi * 0.07))
    line_gap = int(glyph_h * 0.8)
    skew = rng.uniform(-0.01, 0.01)            # baseline slope
    wobble_amp = rng.uniform(0.0, 1.5)
    top = int(rng.integers(30, 60))
    y = top
    while y + glyph_h + 8 < h - 40:
        x = int(rng.integers(18, 30))
        x_end = w - int(rng.integers(18, 40))
        x0_line = x
        y_line = y
        max_y = y
        drew_any = False
        atlas = _glyph_atlas(glyph_h) if repeat_glyphs else None
        while x + glyph_h < x_end:
            if atlas is not None:
                # letter-frequency skew: low indices dominate (Zipf-ish)
                g = atlas[int(len(atlas) * rng.random() ** 2)]
                gw = g.shape[1]
            gy = int(round(y + skew * x + wobble_amp
                           * np.sin(x / 37.0)))
            if gy + glyph_h >= h:
                break
            if atlas is None:
                gw = int(rng.integers(glyph_h // 2, glyph_h))
                g = _glyph(rng, glyph_h, gw)
            ink_layer[gy:gy + glyph_h, x:x + gw] = np.maximum(
                ink_layer[gy:gy + glyph_h, x:x + gw], g)
            max_y = max(max_y, gy + glyph_h)
            drew_any = True
            x += gw + int(rng.integers(2, 6))
            if rng.random() < 0.18:            # word gap
                x += int(rng.integers(4, 10))
        if drew_any:
            lines_meta.append((x0_line, y_line - 2, x_end,
                               max_y + 2))
        y += glyph_h + line_gap

    # --- inverted header band (light text on dark) -------------------
    if inverted_band and lines_meta:
        bx0, by0, bx1, by1 = lines_meta[0]
        band = np.zeros((h, w), bool)
        band[max(0, by0 - 4):by1 + 4, bx0:bx1] = True
        dark = band & (ink_layer < 0.5)
        page[dark] = 60 + 6 * rng.random()
        # the glyphs of line 0 become the light holes
        hole = band & (ink_layer >= 0.5)
        page[hole] = 215
        ink_layer[band] = 0.0   # handled via direct page paint

    # --- remaining text ink ------------------------------------------
    ink_dark = 35.0 + 15.0 * rng.random()
    sel = ink_layer >= 0.5
    page[sel] = ink_dark + rng.normal(0, 4, int(sel.sum()))

    # --- halftone figure ---------------------------------------------
    if halftone:
        fh, fw = h // 5, w // 3
        fy, fx = h - fh - 50, w - fw - 30
        gy, gx = np.mgrid[0:fh, 0:fw]
        tone = 0.15 + 0.7 * (gx / fw)          # gradient tone
        bayer = np.array([[0, 8, 2, 10], [12, 4, 14, 6],
                          [3, 11, 1, 9], [15, 7, 13, 5]]) / 16.0
        dots = tone > bayer[np.tile(np.arange(fh) % 4, (fw, 1)).T,
                            np.tile(np.arange(fw) % 4, (fh, 1))]
        region = page[fy:fy + fh, fx:fx + fw]
        region[dots] = 90
        lines_meta = [m for m in lines_meta
                      if m[3] < fy or m[1] > fy + fh]

    # --- bleed-through ------------------------------------------------
    if bleed:
        verso = ndimage.gaussian_filter(
            ink_layer[:, ::-1].astype(np.float32), 1.2)
        page -= 14.0 * verso

    # --- sensor noise + dust -----------------------------------------
    page = page + rng.normal(0, noise_sigma, (h, w))
    n_specks = int(rng.integers(5, 20))
    for _ in range(n_specks):
        sy, sx = rng.integers(0, h - 3), rng.integers(0, w - 3)
        page[sy:sy + 2, sx:sx + 2] = rng.integers(30, 90)

    page = np.clip(page, 0, 255).astype(np.uint8)

    words = []
    lines = []
    for (x0, y0, x1, y1) in lines_meta:
        lines.append({
            'bbox': [int(x0), int(max(0, y0)), int(x1), int(min(h, y1))],
            'baseline': (float(skew), 0),
            'words': [{'text': 'synthword',
                       'bbox': [int(x0), int(max(0, y0)),
                                int(x1), int(min(h, y1))],
                       'confidence': 90, 'writing_direction': 0,
                       'fontsize': 10}],
        })
    word_data = [{'lines': lines}]
    return page, word_data
