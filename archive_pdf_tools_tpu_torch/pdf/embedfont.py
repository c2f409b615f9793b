# Copied from archive_pdf_tools_tpu/pdf/embedfont.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Embed a TrueType font program as a Type0/Identity-H PDF font.

The reference converts EPUBs through PyMuPDF (``bin/epub-to-pdf:44``),
whose HTML engine renders the book's own ``@font-face`` fonts; this
module gives our from-scratch converter the same capability: the raw
sfnt bytes go in unmodified as ``FontFile2`` under a ``CIDFontType2``
descendant, text is shown as Identity-H glyph-id hex strings, and a
``ToUnicode`` CMap (built from the glyphs actually used) keeps the
text extractable — our own ``pdf/textextract.py`` and any external
reader recover the original characters.

fontTools parses the font (same dependency split as ``pdf/glyphs.py``:
fontTools is the independent font-program parser, the PDF-side logic
is ours).  TrueType-outline sfnts embed as CIDFontType2/FontFile2;
CFF-flavored OpenType (``OTTO``) as CIDFontType0 with FontFile3
``/OpenType``; WOFF1 is unwrapped to its plain sfnt first (WOFF2
would need brotli, absent here).  Unparsable inputs raise
``ValueError`` and the caller falls back to standard-14 substitutes
(documented degradation).
"""

import io
import re

from .writer import Name, Stream

try:
    from fontTools.ttLib import TTFont
    HAVE_FONTTOOLS = True
except ImportError:              # pragma: no cover - baked in
    HAVE_FONTTOOLS = False


class EmbeddedTTF:
    """One embedded TrueType font: advance lookup, glyph-id string
    building (both record usage), deferred W/ToUnicode finalize."""

    def __init__(self, data):
        if not HAVE_FONTTOOLS:
            raise ValueError('fontTools unavailable')
        if data[:4] == b'wOFF':
            # WOFF1 is a zlib-wrapped sfnt: let fontTools unwrap it
            # and re-save the plain font program (WOFF2 would need
            # brotli, absent here -> falls through to the raise)
            try:
                wf = TTFont(io.BytesIO(data), fontNumber=0)
                wf.flavor = None
                buf = io.BytesIO()
                wf.save(buf)
                wf.close()
                data = buf.getvalue()
            except Exception:
                pass
        if data[:4] not in (b'\x00\x01\x00\x00', b'true', b'ttcf',
                            b'OTTO'):
            raise ValueError('not an sfnt font program')
        # CFF-flavored OpenType embeds as FontFile3 /OpenType under a
        # CIDFontType0 (PDF 32000-1 9.9; a non-CID-keyed CFF treats
        # CIDs as glyph indices, which is exactly what we emit)
        self._is_otf = data[:4] == b'OTTO'
        font = TTFont(io.BytesIO(data), fontNumber=0, lazy=True)
        self._data = data
        cmap = font.getBestCmap()
        if not cmap:
            raise ValueError('no unicode cmap')
        upem = float(font['head'].unitsPerEm or 1000)
        hmtx = font['hmtx']
        order = font.getGlyphOrder()
        gid_of = {g: i for i, g in enumerate(order)}
        # char -> (gid, advance em fraction); advances resolved eagerly
        # so lazy table objects never outlive this constructor
        self._map = {}
        for uv, gname in cmap.items():
            gid = gid_of.get(gname)
            if gid is None:
                continue
            try:
                aw = hmtx[gname][0] / upem
            except Exception:
                aw = 0.5
            self._map[uv] = (gid, aw)
        # gid -> advance, for raw-glyph-id users (XPS Indices)
        self._gid_adv = []
        for gname in order:
            try:
                self._gid_adv.append(hmtx[gname][0] / upem)
            except Exception:
                self._gid_adv.append(0.5)
        head = font['head']
        scale = 1000.0 / upem
        hhea = font['hhea']
        try:
            os2 = font['OS/2']
            cap = getattr(os2, 'sCapHeight', 0) or hhea.ascent
        except Exception:
            cap = hhea.ascent
        try:
            italic = font['post'].italicAngle
        except Exception:
            italic = 0
        name6 = ''
        try:
            name6 = font['name'].getDebugName(6) or ''
        except Exception:
            pass
        self.ps_name = re.sub(r'[^!-~]+', '', name6).replace('/', '') \
            or 'EmbeddedTTF'
        self._descr = {
            'bbox': [round(v * scale) for v in
                     (head.xMin, head.yMin, head.xMax, head.yMax)],
            'ascent': round(hhea.ascent * scale),
            'descent': round(hhea.descent * scale),
            'cap': round(cap * scale),
            'italic': italic,
        }
        font.close()
        self._used = {}          # gid -> (unicode, advance/1000)
        self.type0_ref = None
        self._cid_ref = None
        self._tou_ref = None

    def adv(self, ch):
        """Advance of `ch` as an em fraction (0.5 for unmapped chars,
        which render as .notdef).  Records usage."""
        ent = self._map.get(ord(ch))
        if ent is None:
            return 0.5
        self._used[ent[0]] = (ord(ch), ent[1])
        return ent[1]

    def gid_of(self, ch):
        """Glyph id of `ch` (cmap), or None when unmapped."""
        ent = self._map.get(ord(ch))
        return ent[0] if ent else None

    def gid_adv(self, gid, uv=0):
        """Advance of a RAW glyph id as an em fraction (XPS Indices
        name glyphs directly).  Records usage; `uv` feeds ToUnicode
        (0 = no mapping — glyphs without a backing character)."""
        aw = self._gid_adv[gid] if 0 <= gid < len(self._gid_adv) \
            else 0.5
        if gid not in self._used or (uv and not self._used[gid][0]):
            self._used[gid] = (uv, aw)
        return aw

    def hexstr(self, s):
        """`s` as an Identity-H hex string literal (b'<...>'),
        recording every glyph used."""
        out = []
        for ch in s:
            ent = self._map.get(ord(ch))
            if ent is None:
                out.append('0000')
                continue
            self._used[ent[0]] = (ord(ch), ent[1])
            out.append('%04x' % ent[0])
        return ('<%s>' % ''.join(out)).encode('ascii')

    def register(self, writer):
        """Reserve the font object graph; returns the Type0 ref to put
        in page /Font resources.  Call finalize() before save."""
        if self._is_otf:
            ff_ref = writer.add(Stream(
                {Name('Subtype'): Name('OpenType')}, self._data,
                deflate=True))
            ff_key = 'FontFile3'
        else:
            ff_ref = writer.add(Stream(
                {Name('Length1'): len(self._data)}, self._data,
                deflate=True))
            ff_key = 'FontFile2'
        d = self._descr
        descr_ref = writer.add({
            Name('Type'): Name('FontDescriptor'),
            Name('FontName'): Name(self.ps_name),
            Name('Flags'): 4,
            Name('FontBBox'): d['bbox'],
            Name('ItalicAngle'): d['italic'],
            Name('Ascent'): d['ascent'],
            Name('Descent'): d['descent'],
            Name('CapHeight'): d['cap'],
            Name('StemV'): 80,
            Name(ff_key): ff_ref})
        self._descr_ref = descr_ref
        self._cid_ref = writer.reserve()
        self._tou_ref = writer.reserve()
        self.type0_ref = writer.add({
            Name('Type'): Name('Font'),
            Name('Subtype'): Name('Type0'),
            Name('BaseFont'): Name(self.ps_name),
            Name('Encoding'): Name('Identity-H'),
            Name('DescendantFonts'): [self._cid_ref],
            Name('ToUnicode'): self._tou_ref})
        return self.type0_ref

    def finalize(self, writer):
        """Fill in the deferred /W array and ToUnicode CMap from the
        glyphs actually shown."""
        # /W: consecutive-gid runs -> gid [w w ...]
        wout = []
        for gid in sorted(self._used):
            wv = round(self._used[gid][1] * 1000)
            if wout and gid == wout[-1][0] + len(wout[-1][1]):
                wout[-1][1].append(wv)
            else:
                wout.append([gid, [wv]])
        warr = []
        for start, ws in wout:
            warr.append(start)
            warr.append(ws)
        cid = {
            Name('Type'): Name('Font'),
            Name('Subtype'): Name('CIDFontType0' if self._is_otf
                                  else 'CIDFontType2'),
            Name('BaseFont'): Name(self.ps_name),
            Name('CIDSystemInfo'): {Name('Registry'): 'Adobe',
                                    Name('Ordering'): 'Identity',
                                    Name('Supplement'): 0},
            Name('FontDescriptor'): self._descr_ref,
            Name('DW'): 1000,
            Name('W'): warr}
        if not self._is_otf:     # CIDToGIDMap is Type2-only
            cid[Name('CIDToGIDMap')] = Name('Identity')
        writer.set(self._cid_ref, cid)
        pairs = sorted((gid, uv) for gid, (uv, _w) in self._used.items()
                       if uv)     # uv 0: raw gid with no char mapping
        bf = []
        for gid, uv in pairs:
            if uv > 0xffff:      # UTF-16BE surrogate pair
                v = uv - 0x10000
                dst = '%04x%04x' % (0xd800 + (v >> 10),
                                    0xdc00 + (v & 0x3ff))
            else:
                dst = '%04x' % uv
            bf.append('<%04x> <%s>' % (gid, dst))
        # bfchar blocks are capped at 100 entries by the CMap spec
        blocks = []
        for i in range(0, len(bf), 100):
            chunk = bf[i:i + 100]
            blocks.append('%d beginbfchar\n%s\nendbfchar'
                          % (len(chunk), '\n'.join(chunk)))
        cmap = ('/CIDInit /ProcSet findresource begin\n'
                '12 dict begin\nbegincmap\n'
                '/CIDSystemInfo <</Registry (Adobe) /Ordering (UCS) '
                '/Supplement 0>> def\n'
                '/CMapName /Adobe-Identity-UCS def\n/CMapType 2 def\n'
                '1 begincodespacerange\n<0000> <ffff>\n'
                'endcodespacerange\n'
                + '\n'.join(blocks)
                + '\nendcmap\n'
                'CMapName currentdict /CMap defineresource pop\n'
                'end\nend\n').encode('ascii')
        writer.set(self._tou_ref, Stream({}, cmap, deflate=True))
