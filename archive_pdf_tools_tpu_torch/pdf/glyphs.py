# Copied from archive_pdf_tools_tpu/pdf/glyphs.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Glyph-outline resolution for the content-stream rasterizer.

The reference renders text through PyMuPDF's bundled FreeType (every
page render in ``bin/pdf-metadata-json:61-114`` and
``bin/pdf-to-imagestack:18-72`` draws real glyphs).  This module gives
our from-scratch rasterizer the same capability using fontTools as the
font-program parser (an independent sfnt/CFF/Type1 implementation —
no code shared with our PDF writer) plus a small amount of PDF-side
encoding logic:

  * embedded programs: FontFile2 (TrueType), FontFile3 (bare CFF /
    CIDFontType0C / OpenType), FontFile (Type1, rewrapped as PFB for
    fontTools.t1Lib);
  * non-embedded fonts: metric-compatible stand-ins from matplotlib's
    bundled DejaVu family, selected by the standard-14 name /
    FontDescriptor flags (serif, fixed-pitch, bold, italic);
  * code -> glyph mapping: /Encoding Differences + base encodings
    (WinAnsi == cp1252, MacRoman, Standard) for simple fonts,
    (3,0)/(3,1)/(1,0) cmap probing for symbolic TrueType,
    Identity-H/V or embedded CMap streams for Type0/CID fonts,
    CIDToGIDMap streams, CID-keyed CFF charsets, and ToUnicode-driven
    mapping when a stand-in replaces a missing CID font.

Outlines are flattened to polylines in em units (y up) and cached per
code; the rasterizer transforms and scanline-fills them.  Every
resolution failure degrades to ``None`` so the caller can fall back to
the round-1 metric-box rendering.
"""

import io
import os
import re
import struct

import numpy as np

from .reader import PName, PStream

try:
    from fontTools.ttLib import TTFont
    from fontTools.pens.basePen import BasePen
    from fontTools.cffLib import CFFFontSet
    from fontTools.agl import AGL2UV
    from fontTools.encodings.StandardEncoding import StandardEncoding
    HAVE_FONTTOOLS = True
except ImportError:          # pragma: no cover - baked into this image
    HAVE_FONTTOOLS = False
    BasePen = object


class _FlattenPen(BasePen):
    """Flattens moveTo/lineTo/curveTo/qCurveTo into closed polylines
    (font units).  BasePen decomposes composite glyphs (via the
    glyphSet) and splits multi-off-curve qCurveTo segments for us."""

    def __init__(self, glyph_set, steps=8):
        super().__init__(glyph_set)
        self.paths = []
        self._cur = None
        self._steps = steps

    def _moveTo(self, pt):
        if self._cur and len(self._cur) >= 2:
            self.paths.append(self._cur)
        self._cur = [pt]

    def _lineTo(self, pt):
        self._cur.append(pt)

    def _curveToOne(self, p1, p2, p3):
        p0 = self._cur[-1]
        n = self._steps
        for i in range(1, n + 1):
            t = i / n
            mt = 1.0 - t
            self._cur.append((
                mt ** 3 * p0[0] + 3 * mt * mt * t * p1[0]
                + 3 * mt * t * t * p2[0] + t ** 3 * p3[0],
                mt ** 3 * p0[1] + 3 * mt * mt * t * p1[1]
                + 3 * mt * t * t * p2[1] + t ** 3 * p3[1]))

    def _qCurveToOne(self, p1, p2):
        p0 = self._cur[-1]
        n = max(4, self._steps // 2)
        for i in range(1, n + 1):
            t = i / n
            mt = 1.0 - t
            self._cur.append((
                mt * mt * p0[0] + 2 * mt * t * p1[0] + t * t * p2[0],
                mt * mt * p0[1] + 2 * mt * t * p1[1] + t * t * p2[1]))

    def _closePath(self):
        if self._cur and len(self._cur) >= 2:
            self._cur.append(self._cur[0])
            self.paths.append(self._cur)
        self._cur = None

    def _endPath(self):
        self._closePath()


def _parse_cmap_ranges(data):
    """Parse begincidchar/begincidrange (and bfchar/bfrange) sections of
    a CMap stream into {code: value} plus [(lo, hi, base)] ranges."""
    singles = {}
    ranges = []
    txt = data.decode('latin-1', 'replace')
    hexre = r'<([0-9a-fA-F]+)>'

    for m in re.finditer(r'begincidchar(.*?)endcidchar', txt, re.S):
        for c, v in re.findall(hexre + r'\s+(\d+)', m.group(1)):
            singles[int(c, 16)] = int(v)
    for m in re.finditer(r'begincidrange(.*?)endcidrange', txt, re.S):
        for lo, hi, v in re.findall(
                hexre + r'\s*' + hexre + r'\s+(\d+)', m.group(1)):
            ranges.append((int(lo, 16), int(hi, 16), int(v)))
    for m in re.finditer(r'beginbfchar(.*?)endbfchar', txt, re.S):
        for c, v in re.findall(hexre + r'\s*' + hexre, m.group(1)):
            vv = v[:4] if len(v) >= 4 else v
            singles[int(c, 16)] = int(vv, 16)
    for m in re.finditer(r'beginbfrange(.*?)endbfrange', txt, re.S):
        body = m.group(1)
        for lo, hi, v in re.findall(
                hexre + r'\s*' + hexre + r'\s*' + hexre, body):
            ranges.append((int(lo, 16), int(hi, 16), int(v[:4], 16)))
    return singles, ranges


def parse_differences(resolve, enc):
    """/Encoding dict -> {code: glyph name} per ISO 32000-1 9.6.6.3
    (ints reset the code counter, names assign and increment).  The
    shared parser for the rasterizer, std-14 metrics, and text
    extraction; non-name junk entries are skipped."""
    diffs = {}
    if not isinstance(enc, dict):
        return diffs
    code = 0
    try:
        items = resolve(enc.get('Differences')) or []
    except Exception:
        return diffs
    for item in items:
        try:
            item = resolve(item)
        except Exception:
            continue
        if isinstance(item, (int, float)):
            code = int(item)
        elif item is not None and not isinstance(item, (list, dict,
                                                        bytes)):
            diffs[code] = str(item)
            code += 1
    return diffs


def _lookup_ranges(singles, ranges, code):
    v = singles.get(code)
    if v is not None:
        return v
    for lo, hi, base in ranges:
        if lo <= code <= hi:
            return base + (code - lo)
    return None


def _standin_path(base_name, flags):
    """Pick a DejaVu stand-in TTF for a non-embedded font."""
    import matplotlib
    name = (base_name or '').split('+')[-1].lower()
    if 'symbol' in name or 'dingbat' in name:
        return None                      # wrong glyphs beat nothing? no.
    serif = bool(flags & 2) or any(
        s in name for s in ('times', 'serif', 'georgia', 'book', 'roman'))
    mono = bool(flags & 1) or 'courier' in name or 'mono' in name
    bold = 'bold' in name or bool(flags & (1 << 18))
    italic = ('italic' in name or 'oblique' in name
              or bool(flags & (1 << 6)))
    if mono:
        fam, slant = 'DejaVuSansMono', 'Oblique'
    elif serif:
        fam, slant = 'DejaVuSerif', 'Italic'
    else:
        fam, slant = 'DejaVuSans', 'Oblique'
    suffix = ('Bold' if bold else '') + (slant if italic else '')
    if suffix:
        suffix = '-' + suffix
    path = os.path.join(matplotlib.get_data_path(), 'fonts', 'ttf',
                        fam + suffix + '.ttf')
    if not os.path.exists(path):
        path = os.path.join(matplotlib.get_data_path(), 'fonts', 'ttf',
                            fam + '.ttf')
    return path if os.path.exists(path) else None


def _wrap_pfb(data, length1, length2):
    """PDF FontFile payload (cleartext + binary eexec + trailer) ->
    PFB segment framing fontTools.t1Lib can read."""
    if not (0 < length1 <= len(data)) or length2 <= 0 or \
            length1 + length2 > len(data):
        return None
    seg1 = data[:length1]
    seg2 = data[length1:length1 + length2]
    seg3 = data[length1 + length2:]
    if not seg3.strip():
        seg3 = (b'0' * 64 + b'\n') * 8 + b'cleartomark\n'
    out = (b'\x80\x01' + struct.pack('<I', len(seg1)) + seg1
           + b'\x80\x02' + struct.pack('<I', len(seg2)) + seg2
           + b'\x80\x01' + struct.pack('<I', len(seg3)) + seg3
           + b'\x80\x03')
    return out


_MAC_ROMAN = 'mac_roman'

_UV2NAMES = None


def _uv_names(uv):
    """All AGL glyph names for a unicode value (reverse map, built
    lazily once)."""
    global _UV2NAMES
    if _UV2NAMES is None:
        rev = {}
        for nm, u in AGL2UV.items():
            rev.setdefault(u, []).append(nm)
        for lst in rev.values():
            lst.sort(key=len)           # plain names before variants
        _UV2NAMES = rev
    return _UV2NAMES.get(uv, ())


class GlyphSource:
    """Resolves one PDF font dict to flattened glyph outlines.

    ``outline(code)`` returns ``(paths, advance_em)`` — paths is a
    tuple of (N, 2) float64 arrays in em units, possibly empty (space)
    — or ``None`` when the glyph cannot be resolved (caller falls back
    to a metric box).  ``type3`` is True for Type3 fonts, which the
    rasterizer executes as content streams instead."""

    def __init__(self, reader, font):
        self.r = reader
        self.font = font if isinstance(font, dict) else {}
        self.type3 = False
        self.kind = None          # 'sfnt' | 'cff' | 't1'
        self.standin = False
        self._cache = {}
        self._t1font = None
        try:
            if HAVE_FONTTOOLS:
                self._setup()
        except Exception:
            self.kind = None

    # ---- setup ----------------------------------------------------------

    def _setup(self):
        r = self.r
        font = self.font
        sub = str(r.resolve(font.get('Subtype')))
        if sub == 'Type3':
            self.type3 = True
            return
        self.is_cid = sub == 'Type0'
        self.cidfont = None
        self.cmap_singles = self.cmap_ranges = None
        self.cid2gid = None
        self.tounicode = None
        if self.is_cid:
            desc = r.resolve(font.get('DescendantFonts'))
            self.cidfont = r.resolve(desc[0])
            descr = r.resolve(self.cidfont.get('FontDescriptor'))
            enc = r.resolve(font.get('Encoding'))
            if isinstance(enc, PStream):
                self.cmap_singles, self.cmap_ranges = \
                    _parse_cmap_ranges(enc.decoded())
            elif enc is not None and \
                    str(enc) not in ('Identity-H', 'Identity-V'):
                raise ValueError('unsupported predefined CMap %s' % enc)
            c2g = r.resolve(self.cidfont.get('CIDToGIDMap'))
            if isinstance(c2g, PStream):
                self.cid2gid = np.frombuffer(c2g.decoded(), '>u2')
        else:
            descr = r.resolve(font.get('FontDescriptor'))
        self._load_program(r.resolve(descr) if descr else None)
        if not self.is_cid:
            self._build_simple_encoding()
        elif self.standin:
            # stand-in for a CID font: map CID -> unicode via ToUnicode
            tu = r.resolve(font.get('ToUnicode'))
            if isinstance(tu, PStream):
                self.tounicode = _parse_cmap_ranges(tu.decoded())
            else:
                raise ValueError('CID stand-in needs ToUnicode')

    def _load_program(self, descr):
        r = self.r
        data = kind = None
        self.flags = 0
        if isinstance(descr, dict):
            self.flags = int(r.resolve(descr.get('Flags')) or 0)
            for key, k in (('FontFile2', 'sfnt'), ('FontFile3', 'cff3'),
                           ('FontFile', 't1')):
                ff = r.resolve(descr.get(key))
                if isinstance(ff, PStream):
                    data = ff.decoded()
                    kind = k
                    self._ff = ff
                    break
        if data is None:
            base = str(r.resolve(self.font.get('BaseFont')) or '')
            path = _standin_path(base, self.flags)
            if path is None:
                raise ValueError('no embedded program, no stand-in')
            self.standin = True
            self._open_sfnt_file(path)
            return
        if kind == 'cff3' and data[:4] in (b'OTTO', b'\x00\x01\x00\x00',
                                           b'true'):
            kind = 'sfnt'
        if kind == 'sfnt':
            self._open_sfnt(io.BytesIO(data))
        elif kind == 'cff3':
            cff = CFFFontSet()
            cff.decompile(io.BytesIO(data), None)
            self.kind = 'cff'
            self.td = cff[cff.fontNames[0]]
            self.charstrings = self.td.CharStrings
            self.fontmatrix = list(getattr(
                self.td, 'FontMatrix', [0.001, 0, 0, 0.001, 0, 0]))
            self.cid_keyed = hasattr(self.td, 'ROS')
            if self.cid_keyed:
                self._cidname = {}
                for name in self.td.charset:
                    if name.startswith('cid'):
                        try:
                            self._cidname[int(name[3:])] = name
                        except ValueError:
                            pass
                    elif name == '.notdef':
                        self._cidname.setdefault(0, name)
        else:                          # bare Type1
            from fontTools import t1Lib
            l1 = int(r.resolve(self._ff.dict.get('Length1')) or 0)
            l2 = int(r.resolve(self._ff.dict.get('Length2')) or 0)
            pfb = _wrap_pfb(data, l1, l2)
            if pfb is None:
                raise ValueError('bad Type1 segment lengths')
            import tempfile
            fd, path = tempfile.mkstemp(suffix='.pfb')
            try:
                with os.fdopen(fd, 'wb') as fp:
                    fp.write(pfb)
                t1 = t1Lib.T1Font(path)
                t1.parse()
            finally:
                try:
                    os.remove(path)
                except OSError:
                    pass
            self.kind = 't1'
            self._t1font = t1
            self.t1_glyphset = t1.getGlyphSet()
            fm = t1.font.get('FontMatrix', [0.001, 0, 0, 0.001, 0, 0])
            self.fontmatrix = list(fm)
            self.t1_encoding = t1.font.get('Encoding')

    def _open_sfnt_file(self, path):
        self.tt = TTFont(path, lazy=True)
        self._finish_sfnt()

    def _open_sfnt(self, fileobj):
        self.tt = TTFont(fileobj, lazy=True)
        self._finish_sfnt()

    def _finish_sfnt(self):
        self.kind = 'sfnt'
        self.glyphset = self.tt.getGlyphSet()
        self.upm = float(self.tt['head'].unitsPerEm or 1000)
        self.glyph_order = self.tt.getGlyphOrder()
        self._name_set = set(self.glyph_order)
        try:
            self.best_cmap = self.tt.getBestCmap()
        except Exception:
            self.best_cmap = {}
        self._mac_cmap = self._win_sym_cmap = None
        try:
            cmap = self.tt['cmap']
            t = cmap.getcmap(3, 0)
            self._win_sym_cmap = t.cmap if t else None
            t = cmap.getcmap(1, 0)
            self._mac_cmap = t.cmap if t else None
        except Exception:
            pass

    # ---- simple-font encoding --------------------------------------------

    def _build_simple_encoding(self):
        r = self.r
        enc = r.resolve(self.font.get('Encoding'))
        self.diffs = {}
        self.base_enc = None
        if isinstance(enc, (PName, str)):
            self.base_enc = str(enc)
        elif isinstance(enc, dict):
            be = r.resolve(enc.get('BaseEncoding'))
            if be is not None:
                self.base_enc = str(be)
            code = 0
            for item in (r.resolve(enc.get('Differences')) or []):
                item = r.resolve(item)
                if isinstance(item, (int, float)):
                    code = int(item)
                elif isinstance(item, PName):
                    self.diffs[code] = str(item)
                    code += 1

    def _code_to_unicode(self, code):
        be = self.base_enc
        symbolic = bool(self.flags & 4) and not bool(self.flags & 32)
        if be == 'WinAnsiEncoding' or (be is None and not symbolic):
            try:
                return ord(bytes([code]).decode('cp1252'))
            except (UnicodeDecodeError, ValueError):
                return None
        if be == 'MacRomanEncoding':
            try:
                return ord(bytes([code]).decode(_MAC_ROMAN))
            except (UnicodeDecodeError, ValueError):
                return None
        name = StandardEncoding[code]
        return AGL2UV.get(name)

    def _glyphname_candidates(self, code):
        """Simple fonts: /Encoding Differences first, then every AGL
        name for the base encoding's unicode value."""
        name = self.diffs.get(code)
        if name is not None:
            return [name]
        uv = self._code_to_unicode(code)
        if uv is not None:
            return list(_uv_names(uv))
        return []

    # ---- glyph resolution -------------------------------------------------

    def _name_to_unicode(self, name):
        if name in AGL2UV:
            return AGL2UV[name]
        m = re.match(r'^uni([0-9A-Fa-f]{4})', name)
        if m:
            return int(m.group(1), 16)
        m = re.match(r'^u([0-9A-Fa-f]{4,6})$', name)
        if m:
            return int(m.group(1), 16)
        return None

    def _sfnt_gid_for_simple(self, code):
        name = self.diffs.get(code)
        if name is not None and not self.standin:
            if name in self._name_set:
                return name
            uv = self._name_to_unicode(name)
            if uv is not None and uv in self.best_cmap:
                return self.best_cmap[uv]
            m = re.match(r'^(?:g|gid|glyph|index)(\d+)$', name)
            if m:
                gid = int(m.group(1))
                if gid < len(self.glyph_order):
                    return self.glyph_order[gid]
            return None
        symbolic = bool(self.flags & 4) and not bool(self.flags & 32)
        if symbolic and not self.standin:
            for cm in (self._win_sym_cmap, self._mac_cmap):
                if cm:
                    g = cm.get(code) or cm.get(0xF000 | code)
                    if g:
                        return g
        if name is not None:            # stand-in: map via unicode
            uv = self._name_to_unicode(name)
            return self.best_cmap.get(uv) if uv is not None else None
        uv = self._code_to_unicode(code)
        if uv is not None and uv in self.best_cmap:
            return self.best_cmap[uv]
        if symbolic and not self.standin and self._mac_cmap:
            return self._mac_cmap.get(code)
        return None

    def _resolve_cid(self, code):
        if self.cmap_singles is not None:
            cid = _lookup_ranges(self.cmap_singles, self.cmap_ranges,
                                 code)
            if cid is None:
                return None
        else:
            cid = code                  # Identity-H/V
        return cid

    def outline(self, code):
        res = self._cache.get(code)
        if code in self._cache:
            return res
        try:
            res = self._outline_uncached(code)
        except Exception:
            res = None
        self._cache[code] = res
        return res

    def _outline_uncached(self, code):
        if self.kind is None:
            return None
        if self.is_cid:
            cid = self._resolve_cid(code)
            if cid is None:
                return None
            if self.standin:
                uv = _lookup_ranges(*self.tounicode, code)
                if uv is None:
                    return None
                name = self.best_cmap.get(uv)
                if name is None:
                    return None
                return self._draw_sfnt(name)
            if self.kind == 'cff' and self.cid_keyed:
                name = self._cidname.get(cid)
                if name is None:
                    return None
                return self._draw_cff(name)
            gid = cid
            if self.cid2gid is not None:
                if cid >= len(self.cid2gid):
                    return None
                gid = int(self.cid2gid[cid])
            if self.kind == 'sfnt':
                if gid >= len(self.glyph_order):
                    return None
                return self._draw_sfnt(self.glyph_order[gid])
            if self.kind == 'cff':
                order = self.charstrings.keys()
                if gid >= len(order):
                    return None
                return self._draw_cff(self.td.charset[gid])
            return None
        # simple fonts
        if self.kind == 'sfnt':
            name = self._sfnt_gid_for_simple(code)
            return self._draw_sfnt(name) if name is not None else None
        names = []
        if code in self.diffs:
            names = [self.diffs[code]]
        else:
            builtin = None
            if self.kind == 't1' and isinstance(self.t1_encoding, list) \
                    and code < len(self.t1_encoding) and \
                    self.base_enc is None:
                builtin = self.t1_encoding[code]
            elif self.kind == 'cff' and self.base_enc is None:
                enc = getattr(self.td, 'Encoding', None)
                if isinstance(enc, list) and code < len(enc):
                    builtin = enc[code]
            if builtin not in (None, '.notdef'):
                names = [builtin]
            else:
                names = self._glyphname_candidates(code)
        draw = self._draw_cff if self.kind == 'cff' else self._draw_t1
        for name in names:
            if name == '.notdef':
                continue
            out = draw(name)
            if out is not None:
                return out
        return None

    # ---- drawing ----------------------------------------------------------

    def _draw_sfnt(self, name):
        if name not in self._name_set:
            return None
        pen = _FlattenPen(self.glyphset)
        self.glyphset[name].draw(pen)
        pen._endPath()
        s = 1.0 / self.upm
        paths = tuple(np.asarray(p, np.float64) * s for p in pen.paths
                      if len(p) >= 3)
        adv = self.glyphset[name].width * s
        return paths, adv

    def _apply_fontmatrix(self, pts):
        a, b, c, d, e, f = self.fontmatrix
        out = np.empty_like(pts)
        out[:, 0] = a * pts[:, 0] + c * pts[:, 1] + e
        out[:, 1] = b * pts[:, 0] + d * pts[:, 1] + f
        return out

    def _draw_cff(self, name):
        if name not in self.charstrings:
            return None
        cs = self.charstrings[name]
        pen = _FlattenPen(self.charstrings)
        cs.draw(pen)
        pen._endPath()
        paths = tuple(self._apply_fontmatrix(np.asarray(p, np.float64))
                      for p in pen.paths if len(p) >= 3)
        width = getattr(cs, 'width', None)
        adv = (width if width is not None else 500) * self.fontmatrix[0]
        return paths, adv

    def _draw_t1(self, name):
        gs = self.t1_glyphset
        if name not in gs:
            return None
        g = gs[name]
        pen = _FlattenPen(gs)
        g.draw(pen)
        pen._endPath()
        paths = tuple(self._apply_fontmatrix(np.asarray(p, np.float64))
                      for p in pen.paths if len(p) >= 3)
        width = getattr(g, 'width', None)
        adv = (width if width is not None else 500) * self.fontmatrix[0]
        return paths, adv
