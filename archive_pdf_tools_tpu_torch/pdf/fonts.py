# Copied from archive_pdf_tools_tpu/pdf/fonts.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Glyphless CID font embedding for invisible text layers.

Emits the same PDF font object graph the reference's renderer builds by
hand (``pdfrenderer.py:209-329``): a Type0 font with Identity-H
encoding, a CIDFontType2 descendant whose CIDToGIDMap sends every CID to
glyph 1, an identity ToUnicode CMap, and an embedded TrueType program
(our generated data/glyphless.ttf; the advance is DW = 1000/2 = 500).
"""

import os
import zlib

import numpy as np

from .writer import Name, Ref, Stream

K_CHAR_WIDTH = 2  # em is split in half; DW = 1000 // K_CHAR_WIDTH

_FONT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'data', 'glyphless.ttf')

_TOUNICODE_CMAP = b'''/CIDInit /ProcSet findresource begin
12 dict begin
begincmap
/CIDSystemInfo
<<
  /Registry (Adobe)
  /Ordering (UCS)
  /Supplement 0
>> def
/CMapName /Adobe-Identity-UCS def
/CMapType 2 def
1 begincodespacerange
<0000> <FFFF>
endcodespacerange
1 beginbfrange
<0000> <FFFF> <0000>
endbfrange
endcmap
CMapName currentdict /CMap defineresource pop
end
end
'''


def add_glyphless_font(writer):
    """Add the font object graph; returns the Type0 font Ref."""
    # CIDToGIDMap: 2 bytes per CID, every CID -> GID 1
    cid2gid = np.zeros(2 * (1 << 16), dtype=np.uint8)
    cid2gid[1::2] = 1
    cid2gid_ref = writer.add(Stream(
        {}, zlib.compress(cid2gid.tobytes()), deflate=False))
    writer.get(cid2gid_ref).dict[Name('Filter')] = Name('FlateDecode')

    tounicode_ref = writer.add(Stream({}, _TOUNICODE_CMAP))

    with open(_FONT_PATH, 'rb') as fp:
        font_data = fp.read()
    fontfile_ref = writer.add(Stream({Name('Length1'): len(font_data)},
                                     font_data))

    descriptor_ref = writer.add({
        Name('Type'): Name('FontDescriptor'),
        Name('FontName'): Name('GlyphLessFont'),
        Name('Flags'): 5,
        Name('FontBBox'): [0, 0, 1000 // K_CHAR_WIDTH, 1000],
        Name('Ascent'): 1000,
        Name('CapHeight'): 1000,
        Name('Descent'): -1,
        Name('ItalicAngle'): 0,
        Name('StemV'): 80,
        Name('FontFile2'): fontfile_ref,
    })

    cidfont_ref = writer.add({
        Name('Type'): Name('Font'),
        Name('Subtype'): Name('CIDFontType2'),
        Name('BaseFont'): Name('GlyphLessFont'),
        Name('CIDToGIDMap'): cid2gid_ref,
        Name('CIDSystemInfo'): {
            Name('Registry'): 'Adobe',
            Name('Ordering'): 'Identity',
            Name('Supplement'): 0,
        },
        Name('FontDescriptor'): descriptor_ref,
        Name('DW'): 1000 // K_CHAR_WIDTH,
    })

    return writer.add({
        Name('Type'): Name('Font'),
        Name('Subtype'): Name('Type0'),
        Name('BaseFont'): Name('GlyphLessFont'),
        Name('DescendantFonts'): [cidfont_ref],
        Name('Encoding'): Name('Identity-H'),
        Name('ToUnicode'): tounicode_ref,
    })
