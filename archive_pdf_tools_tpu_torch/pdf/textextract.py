# Copied from archive_pdf_tools_tpu/pdf/textextract.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""PDF text-layer extraction to hOCR.

In-tree replacement for the external ``pdf-to-hocr`` tool the
reference's ``bin/pdfcomp`` shells out to (``bin/pdfcomp:31`` — it
depends on archive-hocr-tools, an out-of-repo package): walk each
page's content stream with the rasterizer's interpreter in glyph-sink
mode (no painting), resolve glyph codes to unicode (ToUnicode CMap
first, then /Differences glyph names, then the simple-font base
encoding), group glyphs into words and baselines into lines, and emit
hOCR that ``inputs/hocr.py`` (and any hOCR consumer) can parse.

Coordinates: device pixels, top-left origin, at ``scale`` pixels per
PDF unit (ppi = 72 * scale) — the raster space ``pdf-to-imagestack``
renders at, so word boxes line up with the rendered page image.
"""

import re

from .raster import Rasterizer, _GState
from .reader import PdfReader, PStream

_HEXSTR = r'<([0-9a-fA-F]+)>'


def _utf16be_hex_to_str(hx):
    if len(hx) % 4:
        hx = hx[:len(hx) - len(hx) % 4]
    if not hx:
        return ''
    try:
        return bytes.fromhex(hx).decode('utf-16-be', 'ignore')
    except ValueError:
        return ''


def parse_tounicode(data):
    """ToUnicode CMap -> {code: str}.  Unlike the CID parser in
    pdf/glyphs.py this keeps full multi-char bf values (ligatures).
    Spec: ISO 32000-1 9.10.3; reference consumes the same streams via
    PyMuPDF's text extraction."""
    out = {}
    txt = data.decode('latin-1', 'replace')
    for m in re.finditer(r'beginbfchar(.*?)endbfchar', txt, re.S):
        for c, v in re.findall(_HEXSTR + r'\s*' + _HEXSTR, m.group(1)):
            s = _utf16be_hex_to_str(v)
            if s:
                out[int(c, 16)] = s
    for m in re.finditer(r'beginbfrange(.*?)endbfrange', txt, re.S):
        body = m.group(1)
        # <lo> <hi> <base>
        for lo, hi, v in re.findall(
                _HEXSTR + r'\s*' + _HEXSTR + r'\s*' + _HEXSTR, body):
            lo_i, hi_i = int(lo, 16), int(hi, 16)
            base = _utf16be_hex_to_str(v)
            if not base or hi_i - lo_i > 65535:
                continue
            last = ord(base[-1])
            for c in range(lo_i, hi_i + 1):
                out.setdefault(
                    c, base[:-1] + chr(last + (c - lo_i)))
        # <lo> <hi> [<dst> <dst> ...]
        for lo, _hi, arr in re.findall(
                _HEXSTR + r'\s*' + _HEXSTR + r'\s*\[(.*?)\]', body,
                re.S):
            lo_i = int(lo, 16)
            for j, v in enumerate(re.findall(_HEXSTR, arr)):
                s = _utf16be_hex_to_str(v)
                if s:
                    out[lo_i + j] = s
    return out


def _name_to_unicode(name):
    """AGL glyph name (or uniXXXX/uXXXXXX form) -> unicode value."""
    try:
        from fontTools.agl import AGL2UV
    except Exception:
        AGL2UV = {}
    if name in AGL2UV:
        return AGL2UV[name]
    m = re.match(r'^uni([0-9A-Fa-f]{4})', name)
    if m:
        return int(m.group(1), 16)
    m = re.match(r'^u([0-9A-Fa-f]{4,6})$', name)
    if m:
        return int(m.group(1), 16)
    return None


class _FontText:
    """Per-font code->unicode resolver: ToUnicode CMap, then /Encoding
    Differences glyph names (covers Type1/TrueType/Type3 — matplotlib's
    PDF backend emits Type3 subsets this way), then the base encoding,
    then an ASCII fallback for bare fonts."""

    def __init__(self, reader, font, glyph_source):
        self.src = glyph_source
        self.map = None
        self.diffs = {}
        self.is_cid = False
        if not isinstance(font, dict):
            return
        try:
            self.is_cid = str(reader.resolve(font.get('Subtype'))) \
                == 'Type0'
            tu = reader.resolve(font.get('ToUnicode'))
            if isinstance(tu, PStream):
                self.map = parse_tounicode(tu.decoded())
        except Exception:
            self.map = None
        from .glyphs import parse_differences
        try:
            enc = reader.resolve(font.get('Encoding'))
        except Exception:
            enc = None
        self.diffs = parse_differences(reader.resolve, enc)

    def unicode(self, code):
        if self.map is not None:
            s = self.map.get(code)
            if s:
                return s
        name = self.diffs.get(code)
        if name is not None:
            uv = _name_to_unicode(name)
            if uv is not None:
                return chr(uv)
        src = self.src
        if src is not None and not getattr(src, 'is_cid', False):
            try:
                uv = src._code_to_unicode(code)
                if uv is not None:
                    return chr(uv)
            except Exception:
                pass
        if self.map is None and src is None and not self.is_cid \
                and 32 <= code < 127:
            # no font program, no ToUnicode: assume ASCII-compatible
            return chr(code)
        return None


def extract_page_glyphs(reader, idx, scale=1.0):
    """[(text, x0, y0, x1, y1, baseline_y, run, fs_dev)] in device
    (top-left origin) pixels; space glyphs become forced word breaks
    (text '').  Returns (glyphs, width, height)."""
    r = reader
    page = r.pages()[idx]
    box = r._inherited(page, 'MediaBox') or [0, 0, 612, 792]
    box = [float(r.resolve(v)) for v in box]
    pw, ph = box[2] - box[0], box[3] - box[1]
    W = max(1, int(round(pw * scale)))
    H = max(1, int(round(ph * scale)))

    ras = Rasterizer(r)
    ras.skip_images = True
    ras._text_record = []
    gs = _GState()
    gs.ctm = (scale, 0.0, 0.0, -scale, -box[0] * scale, box[3] * scale)
    res = r._inherited(page, 'Resources') or {}
    import numpy as np
    canvas = np.zeros((1, 1, 3), np.float32)   # nothing paints
    try:
        ras._execute(r.page_contents(idx), res, canvas, gs, depth=0)
    except Exception:
        pass

    fonts = {}
    glyphs = []
    for font, code, nbytes, run, orig, xend, asc, desc, fs \
            in ras._text_record:
        key = id(font)
        ft = fonts.get(key)
        if ft is None:
            ft = _FontText(r, font, ras._glyph_source(font))
            fonts[key] = ft
        text = ft.unicode(code)
        if text is not None and text.strip() == '':
            text = ''                     # explicit space: word break
        # metric quad -> axis-aligned box
        xs = [orig[0], xend[0], asc[0], desc[0]]
        ys = [orig[1], xend[1], asc[1], desc[1]]
        fs_dev = ((asc[0] - desc[0]) ** 2
                  + (asc[1] - desc[1]) ** 2) ** 0.5 / 0.9
        # orientation from the advance vector (orig -> advance end);
        # zero-advance glyphs fall back to the up-vector (asc - desc;
        # never zero) rotated -90 deg = (-uy, ux).  Quantized to the
        # four page orientations: 0 = left-to-right, 1 = top-to-bottom
        # (rotated 90 cw OR WMode-1 vertical CJK), 2 = right-to-left
        # (upside down), 3 = bottom-to-top (90 ccw).
        ux, uy = asc[0] - desc[0], asc[1] - desc[1]
        dx, dy = xend[0] - orig[0], xend[1] - orig[1]
        if dx * dx + dy * dy < 1e-12:
            dx, dy = -uy, ux
        if abs(dx) >= abs(dy):
            ddir = 0 if dx >= 0 else 2
        else:
            ddir = 1 if dy >= 0 else 3
        # upright glyphs advancing vertically (WMode 1): the quad's
        # points share one x — widen by the glyph cell (v_x centres a
        # full-width glyph on the origin, so half an em each side)
        if (ddir in (1, 3)) == (abs(ux) <= abs(uy)):
            half = 0.45 * fs_dev
            un = max((ux * ux + uy * uy) ** 0.5, 1e-9)
            ex, ey = -uy / un * half, ux / un * half
            xs += [orig[0] - ex, orig[0] + ex]
            ys += [orig[1] - ey, orig[1] + ey]
        # reading-order coordinates: 'along' grows with the advance,
        # 'cross' is the baseline position normal to it
        if ddir == 0:
            a0, a1, cross = orig[0], xend[0], orig[1]
        elif ddir == 2:
            a0, a1, cross = -orig[0], -xend[0], orig[1]
        elif ddir == 1:
            a0, a1, cross = orig[1], xend[1], orig[0]
        else:
            a0, a1, cross = -orig[1], -xend[1], orig[0]
        glyphs.append((text, min(xs), min(ys), max(xs), max(ys),
                       cross, run, fs_dev, a0, max(a0, a1), ddir))
    return glyphs, W, H


def group_words(glyphs):
    """Greedy reading-order grouping of glyphs into words.

    Grouping runs in reading-order coordinates ('along' the quantized
    advance direction, 'cross' normal to it), so 90/180/270-degree
    rotated text groups exactly like horizontal text.  A word breaks
    on: an explicit space glyph, an orientation change, a gap over
    0.3 em between the previous glyph's along-end and the next glyph's
    along-start, a gap over 0.08 em at a text-run boundary (each word
    its own Td/TJ — our own text layer, Tesseract's), a backwards
    jump, or a baseline shift over 0.35 em.
    Returns [(text, bbox, cross, fs, dir)]."""
    words = []
    cur = None

    def flush():
        nonlocal cur
        if cur is not None and cur['text']:
            words.append((cur['text'],
                          (cur['x0'], cur['y0'], cur['x1'], cur['y1']),
                          cur['base'], cur['fs'], cur['dir']))
        cur = None

    for (text, x0, y0, x1, y1, base, run, fs, a0, a1, ddir) in glyphs:
        if text == '':
            flush()
            continue
        if text is None:
            text = '�'
        em = max(fs, 1e-6)
        if cur is not None:
            gap = a0 - cur['aend']
            if ddir != cur['dir'] or gap > 0.30 * em \
                    or gap < -1.5 * em \
                    or (run != cur['run'] and gap > 0.08 * em) \
                    or abs(base - cur['base']) > 0.35 * em:
                flush()
        if cur is None:
            cur = {'text': '', 'x0': x0, 'y0': y0, 'x1': x1, 'y1': y1,
                   'base': base, 'fs': fs, 'aend': a1, 'run': run,
                   'dir': ddir}
        cur['text'] += text
        cur['x0'] = min(cur['x0'], x0)
        cur['y0'] = min(cur['y0'], y0)
        cur['x1'] = max(cur['x1'], x1)
        cur['y1'] = max(cur['y1'], y1)
        cur['aend'] = max(cur['aend'], a1)
        cur['base'] = base
        cur['fs'] = max(cur['fs'], fs)
        cur['run'] = run
    flush()
    return words


def _along0(w):
    """Reading-order start coordinate of a word from its bbox + dir."""
    bbox, ddir = w[1], w[4]
    return (bbox[0], bbox[1], -bbox[2], -bbox[3])[ddir]


def group_lines(words):
    """Cluster words into lines by (orientation, baseline) proximity,
    ordered in reading order within the line.

    Returns [{'bbox', 'baseline_y', 'x_size', 'dir', 'words': [...]}]
    sorted top-to-bottom."""
    remaining = sorted(words, key=lambda w: (w[4], w[2], _along0(w)))
    lines = []
    for w in remaining:
        placed = None
        for ln in lines:
            if ln['dir'] == w[4] and \
                    abs(w[2] - ln['baseline_y']) <= 0.5 * max(
                        w[3], ln['x_size']):
                placed = ln
                break
        if placed is None:
            placed = {'bbox': list(w[1]), 'baseline_y': w[2],
                      'x_size': w[3], 'dir': w[4], 'words': []}
            lines.append(placed)
        placed['words'].append(w)
        placed['bbox'][0] = min(placed['bbox'][0], w[1][0])
        placed['bbox'][1] = min(placed['bbox'][1], w[1][1])
        placed['bbox'][2] = max(placed['bbox'][2], w[1][2])
        placed['bbox'][3] = max(placed['bbox'][3], w[1][3])
        placed['x_size'] = max(placed['x_size'], w[3])
        # running baseline: last word wins (words arrive sorted)
        placed['baseline_y'] = w[2]
    # split lines at over-wide horizontal gaps (column gutters): two
    # columns sharing a baseline grid must not fuse into one ocr_line,
    # or the XY-cut never sees the gutter
    split = []
    for ln in lines:
        ln['words'].sort(key=_along0)
        cur = None
        for w in ln['words']:
            gap_limit = 2.5 * max(ln['x_size'], 1.0)
            if cur is not None and ln['dir'] in (0, 2):
                prev_end = cur['words'][-1][1][2] if ln['dir'] == 0 \
                    else None
                gap = (w[1][0] - prev_end) if ln['dir'] == 0 else \
                    (cur['words'][-1][1][0] - w[1][2])
                if gap > gap_limit:
                    split.append(cur)
                    cur = None
            if cur is None:
                cur = {'bbox': list(w[1]), 'baseline_y': ln['baseline_y'],
                       'x_size': ln['x_size'], 'dir': ln['dir'],
                       'words': []}
            cur['words'].append(w)
            cur['bbox'][0] = min(cur['bbox'][0], w[1][0])
            cur['bbox'][1] = min(cur['bbox'][1], w[1][1])
            cur['bbox'][2] = max(cur['bbox'][2], w[1][2])
            cur['bbox'][3] = max(cur['bbox'][3], w[1][3])
        if cur is not None:
            split.append(cur)
    split.sort(key=lambda ln: (ln['bbox'][1], ln['bbox'][0]))
    return split


_XML_BAD = re.compile(
    # XML 1.0 invalid: C0 controls except \t\n\r, lone surrogates,
    # U+FFFE/FFFF (ToUnicode CMaps in the wild map codes to these)
    '[\x00-\x08\x0b\x0c\x0e-\x1f\ud800-\udfff￾￿]')


def _esc(s):
    s = _XML_BAD.sub('�', s)
    return (s.replace('&', '&amp;').replace('<', '&lt;')
            .replace('>', '&gt;'))


def _merged_gaps(intervals, min_gap):
    """Gaps wider than min_gap between merged [lo, hi) intervals."""
    ivs = sorted(intervals)
    gaps = []
    hi = None
    for lo, h in ivs:
        if hi is not None and lo - hi > min_gap:
            gaps.append((hi, lo))
        hi = h if hi is None else max(hi, h)
    return gaps


def order_reading(lines):
    """Recursive XY-cut over line boxes: split on full-width vertical
    gaps (bands, top to bottom), then on full-height horizontal gutters
    (columns, left to right) — so two-column pages read left column
    first instead of interleaving, while spanning titles stay on top."""
    def cut(items, depth):
        # vertical-majority blocks (WMode-1 CJK) read columns right to
        # left; each vertical line IS a column, so order by x desc
        vert = sum(1 for ln in items if ln['dir'] == 1) > len(items) / 2
        if len(items) <= 1 or depth >= 6:
            if vert:
                return sorted(items, key=lambda ln: (-ln['bbox'][2],
                                                     ln['bbox'][1]))
            return sorted(items, key=lambda ln: (ln['bbox'][1],
                                                 ln['bbox'][0]))
        ms = sorted(ln['x_size'] for ln in items)[len(items) // 2]
        ms = max(ms, 1.0)
        y_gaps = _merged_gaps([(ln['bbox'][1], ln['bbox'][3])
                               for ln in items], 0.6 * ms)
        x_gaps = _merged_gaps([(ln['bbox'][0], ln['bbox'][2])
                               for ln in items], 1.0 * ms)
        # cut the axis with the WIDER gap: a full-height gutter must
        # beat ordinary inter-line gaps, or columns sharing a leading
        # grid band-split first and interleave anyway
        max_y = max((g[1] - g[0] for g in y_gaps), default=0.0)
        max_x = max((g[1] - g[0] for g in x_gaps), default=0.0)
        if x_gaps and max_x > max_y:
            cols = [[] for _ in range(len(x_gaps) + 1)]
            cuts = [g[0] for g in x_gaps]
            for ln in items:
                k = sum(1 for c in cuts if ln['bbox'][0] >= c)
                cols[k].append(ln)
            out = []
            for col in (reversed(cols) if vert else cols):
                out.extend(cut(col, depth + 1))
            return out
        if y_gaps:
            bands = [[] for _ in range(len(y_gaps) + 1)]
            cuts = [g[0] for g in y_gaps]
            for ln in items:
                k = sum(1 for c in cuts if ln['bbox'][1] >= c)
                bands[k].append(ln)
            out = []
            for band in bands:
                out.extend(cut(band, depth + 1))
            return out
        if vert:
            return sorted(items, key=lambda ln: (-ln['bbox'][2],
                                                 ln['bbox'][1]))
        return sorted(items, key=lambda ln: (ln['bbox'][1],
                                             ln['bbox'][0]))

    return cut(list(lines), 0)


def group_paragraphs(lines):
    """Split the top-to-bottom line list into paragraphs on vertical
    gaps over ~1.8 line-heights, orientation changes, or horizontal
    disjointness (column breaks)."""
    paras = []
    cur = []
    for ln in lines:
        if cur:
            prev = cur[-1]
            gap = ln['bbox'][1] - prev['bbox'][3]
            x_ov = min(ln['bbox'][2], prev['bbox'][2]) - \
                max(ln['bbox'][0], prev['bbox'][0])
            if ln['dir'] != prev['dir'] \
                    or gap > 1.8 * max(ln['x_size'], prev['x_size']) \
                    or x_ov <= 0:
                paras.append(cur)
                cur = []
        cur.append(ln)
    if cur:
        paras.append(cur)
    return paras


def page_to_hocr(reader, idx, scale=1.0, pageno=None):
    """One ocr_page div (bytes, utf-8)."""
    glyphs, W, H = extract_page_glyphs(reader, idx, scale=scale)
    lines = order_reading(group_lines(group_words(glyphs)))
    pageno = idx if pageno is None else pageno
    ppi = int(round(72 * scale))
    out = ["<div class='ocr_page' id='page_%06d' title='bbox 0 0 %d %d; "
           "ppageno %d; scan_res %d %d'>" % (pageno + 1, W, H, pageno,
                                             ppi, ppi)]
    li = 0
    for para in group_paragraphs(lines):
        x0 = min(ln['bbox'][0] for ln in para)
        y0 = min(ln['bbox'][1] for ln in para)
        x1 = max(ln['bbox'][2] for ln in para)
        y1 = max(ln['bbox'][3] for ln in para)
        out.append(" <div class='ocr_carea' title='bbox %d %d %d %d'>"
                   % (x0, y0, x1, y1))
        out.append("  <p class='ocr_par' dir='ltr' "
                   "title='bbox %d %d %d %d'>" % (x0, y0, x1, y1))
        for ln in para:
            li += 1
            bx = [int(round(v)) for v in ln['bbox']]
            base_off = int(round(ln['baseline_y'] - ln['bbox'][3])) \
                if ln.get('dir', 0) in (0, 2) else 0
            out.append("   <span class='ocr_line' id='line_%06d_%04d' "
                       "title='bbox %d %d %d %d; baseline 0 %d; "
                       "x_size %d'>" % (pageno + 1, li, bx[0], bx[1],
                                        bx[2], bx[3], base_off,
                                        int(round(ln['x_size']))))
            for wi, (text, wb, _base, fs, _dir) in enumerate(
                    ln['words']):
                wb = [int(round(v)) for v in wb]
                out.append("    <span class='ocrx_word' "
                           "id='word_%06d_%04d_%04d' title='bbox %d %d "
                           "%d %d; x_wconf 100; x_fsize %d'>%s</span>"
                           % (pageno + 1, li, wi, wb[0], wb[1], wb[2],
                              wb[3], max(1, int(round(fs * 72.0 / max(
                                  ppi, 1)))), _esc(text)))
            out.append("   </span>")
        out.append("  </p>")
        out.append(" </div>")
    out.append("</div>")
    return '\n'.join(out).encode('utf-8')


HOCR_HEADER = b"""<?xml version="1.0" encoding="UTF-8"?>
<!DOCTYPE html PUBLIC "-//W3C//DTD XHTML 1.0 Transitional//EN" "http://www.w3.org/TR/xhtml1/DTD/xhtml1-transitional.dtd">
<html xmlns="http://www.w3.org/1999/xhtml" xml:lang="en" lang="en">
 <head>
  <title></title>
  <meta http-equiv="Content-Type" content="text/html;charset=utf-8"/>
  <meta name='ocr-system' content='archive-pdf-tools-tpu pdf-to-hocr'/>
  <meta name='ocr-capabilities' content='ocr_page ocr_carea ocr_par ocr_line ocrx_word'/>
 </head>
 <body>
"""

HOCR_FOOTER = b""" </body>
</html>
"""


def pdf_to_hocr(pdf_path_or_reader, out_fp, scales=None,
                default_scale=1.0):
    """Write a whole-document hOCR to ``out_fp`` (binary).

    scales: optional per-page scale list (e.g. estimated_ppi/72 from
    pdf-metadata-json); default_scale applies elsewhere."""
    reader = pdf_path_or_reader
    if not isinstance(reader, PdfReader):
        reader = PdfReader(reader)
    out_fp.write(HOCR_HEADER)
    for idx in range(reader.page_count()):
        scale = default_scale
        if scales is not None and idx < len(scales) and scales[idx]:
            scale = scales[idx]
        out_fp.write(page_to_hocr(reader, idx, scale=scale))
        out_fp.write(b'\n')
    out_fp.write(HOCR_FOOTER)
