# Copied from archive_pdf_tools_tpu/pdf/builder.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""PDF document assembly: pages, MRC image stacks, PDF/A + UA trimmings.

Replaces the reference's PyMuPDF-dependent assembly (``pdfhacks.py``
whole file, plus the xref bookkeeping of ``pdfrenderer.py``) with our own
object writer.  One builder holds the whole document in memory; the
recode pipeline adds the text layer in pass 1 and splices raw
pre-compressed image streams in pass 2 (no re-encode, the moral
equivalent of ``fast_insert_image``, ``pdfhacks.py:106-177``).
"""

import os
import struct
from datetime import datetime, timezone
from xml.sax.saxutils import escape as xmlescape

from ..const import (PRODUCER, COMPRESSOR_JPEG, COMPRESSOR_JPEG2000,
                     COMPRESSOR_JBIG2, COMPRESSOR_CCITT,
                     RECODE_RUNTIME_WARNING_INVALID_PAGE_NUMBERS)
from .writer import PdfWriter, Name, Stream
from .fonts import add_glyphless_font
from .textlayer import page_text_ops
from .pagenumbers import parse_series, series_to_pagelabels


def _now():
    # reproducible-builds.org convention: SOURCE_DATE_EPOCH pins every
    # emitted timestamp (also what the byte-identity tests use to
    # compare single-device vs mesh-sharded pipeline output)
    sde = os.environ.get('SOURCE_DATE_EPOCH')
    if sde:
        return datetime.fromtimestamp(int(sde), timezone.utc)
    return datetime.now(timezone.utc)


def _pdf_date(dt=None):
    return 'D:' + (dt or _now()).strftime('%Y%m%d%H%M%S') + 'Z'


def srgb_icc_bytes():
    """An sRGB ICC profile for the PDF/A OutputIntent; generated with
    littleCMS via Pillow instead of shipping a binary blob
    (reference ships data/tmp.icc, used at ``pdfhacks.py:189``).
    littleCMS stamps the profile header's dateTimeNumber (bytes 24-35)
    with the build time; we pin it to _now() (SOURCE_DATE_EPOCH-aware)
    so identical runs emit identical files."""
    from PIL import ImageCms
    icc = bytearray(
        ImageCms.ImageCmsProfile(ImageCms.createProfile('sRGB')).tobytes())
    dt = _now()
    icc[24:36] = struct.pack('>6H', dt.year, dt.month, dt.day,
                             dt.hour, dt.minute, dt.second)
    # the header's profile-ID field (bytes 84-99) is an MD5 over the
    # profile with that field zeroed; current littleCMS leaves it
    # zeroed, but if a future version stamps it, the checksum would go
    # stale against the patched dateTime above — zero means "not
    # computed", which is always valid (ICC.1 clause 7.2.18)
    icc[84:100] = bytes(16)
    return bytes(icc)


class PageState:
    def __init__(self, ref, width, height):
        self.ref = ref
        self.width = width
        self.height = height
        self.text_ops = b''
        self.extra_ops = b''      # raw operators appended after images
        self.images = []          # (name, xobj_ref) draw order
        self.extra = {}


class DocumentBuilder:
    """Builds the output PDF for the recode pipeline."""

    def __init__(self, render_text_lines=False):
        self.w = PdfWriter()
        self.render_text_lines = render_text_lines
        self.catalog_ref = self.w.reserve()
        self.pages_ref = self.w.reserve()
        self.font_ref = add_glyphless_font(self.w)
        self.pages = []
        self.catalog_extra = {}
        self.info = {Name('Producer'): PRODUCER,
                     Name('CreationDate'): _pdf_date()}
        self.xmp = None
        self._img_count = 0

    # ---- pass 1: text pages -------------------------------------------

    def add_text_page(self, word_data, width, height, ppi, hocr_ppi=None):
        """Page with an invisible text layer (``pdfrenderer.py:390-443``)."""
        ref = self.w.reserve()
        page = PageState(ref, width, height)
        if word_data:
            page.text_ops = page_text_ops(
                word_data, width, height, ppi,
                render_text_lines=self.render_text_lines)
        self.pages.append(page)
        return len(self.pages) - 1

    # ---- pass 2: images -------------------------------------------------

    def _image_dict(self, enc, gray, smask_ref=None):
        d = {
            Name('Type'): Name('XObject'),
            Name('Subtype'): Name('Image'),
            Name('Width'): enc.width,
            Name('Height'): enc.height,
        }
        fmt = enc.fmt
        if fmt == COMPRESSOR_JPEG2000:
            d[Name('BitsPerComponent')] = 8
            d[Name('ColorSpace')] = Name('DeviceGray' if gray else 'DeviceRGB')
            d[Name('Filter')] = Name('JPXDecode')
        elif fmt == COMPRESSOR_JPEG:
            d[Name('BitsPerComponent')] = 8
            d[Name('ColorSpace')] = Name('DeviceGray' if gray else 'DeviceRGB')
            d[Name('Filter')] = Name('DCTDecode')
        elif fmt == COMPRESSOR_JBIG2:
            d[Name('BitsPerComponent')] = 1
            d[Name('ColorSpace')] = Name('DeviceGray')
            d[Name('Filter')] = Name('JBIG2Decode')
            if getattr(enc, 'decode', None):
                d[Name('Decode')] = list(enc.decode)
        elif fmt == COMPRESSOR_CCITT:
            d[Name('BitsPerComponent')] = 1
            d[Name('ColorSpace')] = Name('DeviceGray')
            d[Name('Filter')] = Name('CCITTFaxDecode')
            d[Name('DecodeParms')] = {
                Name('K'): -1, Name('Columns'): enc.width,
                Name('Rows'): enc.height, Name('BlackIs1'): True}
        elif fmt == 'flate1':
            d[Name('BitsPerComponent')] = 1
            d[Name('ColorSpace')] = Name('DeviceGray')
            d[Name('Filter')] = Name('FlateDecode')
            if getattr(enc, 'decode', None):
                d[Name('Decode')] = list(enc.decode)
        else:
            raise ValueError('unknown stream format %r' % (fmt,))
        if smask_ref is not None:
            d[Name('SMask')] = smask_ref
        return d

    @staticmethod
    def _png_to_flate1(enc):
        """PNG masks (recode(jbig2=False), reference recode.py:376)
        become Flate 1-bit images at insertion — the raw-splice writer
        has no PNG filter, and PDF has no PNG container anyway (the
        reference gets this conversion for free from PyMuPDF)."""
        if getattr(enc, 'fmt', None) != 'png':
            return enc
        import io
        import zlib
        import types
        import numpy as np
        from PIL import Image
        with Image.open(io.BytesIO(enc.data)) as im:
            m = np.asarray(im.convert('1'), dtype=bool)
        data = zlib.compress(np.packbits(m, axis=-1).tobytes(), 6)
        return types.SimpleNamespace(
            data=data, fmt='flate1', width=enc.width, height=enc.height,
            decode=getattr(enc, 'decode', None))

    def insert_image(self, page_idx, enc, gray=True, mask_enc=None):
        """Raw-stream image insertion (``pdfhacks.py:106-177`` analog).
        Returns the image XObject Ref."""
        page = self.pages[page_idx]
        enc = self._png_to_flate1(enc)
        smask_ref = None
        if mask_enc is not None:
            mask_enc = self._png_to_flate1(mask_enc)
            smask = Stream(self._image_dict(mask_enc, True), mask_enc.data)
            smask_ref = self.w.add(smask)
        xobj = Stream(self._image_dict(enc, gray, smask_ref), enc.data)
        ref = self.w.add(xobj)
        name = 'Im%d' % self._img_count
        self._img_count += 1
        page.images.append((name, ref))
        return ref

    def insert_raw_mask_page(self, page_idx, mask_enc):
        """A 1-bit page whose single image *is* the mask (reference
        bw/1-bit path, ``recode.py:376-425``)."""
        return self.insert_image(page_idx, mask_enc, gray=True)

    # ---- finalize --------------------------------------------------------

    def write_pdfa(self):
        """PDF/A OutputIntent with embedded sRGB ICC
        (``pdfhacks.py:181-208``)."""
        icc = srgb_icc_bytes()
        icc_ref = self.w.add(Stream({Name('N'): 3,
                                     Name('Alternate'): Name('DeviceRGB')},
                                    icc, deflate=True))
        intent_ref = self.w.add({
            Name('Type'): Name('OutputIntent'),
            Name('S'): Name('GTS_PDFA1'),
            Name('OutputConditionIdentifier'): 'Custom',
            Name('Info'): 'sRGB IEC61966-2.1',
            Name('DestOutputProfile'): icc_ref,
        })
        self.catalog_extra[Name('OutputIntents')] = [intent_ref]

    def write_page_labels(self, page_numbers, errors=None,
                          ignore_invalid=False):
        """(``pdfhacks.py:211-224``)"""
        runs, all_ok = parse_series(page_numbers,
                                    ignore_invalid=ignore_invalid)
        if errors is not None and not all_ok:
            errors.add(RECODE_RUNTIME_WARNING_INVALID_PAGE_NUMBERS)
        self.catalog_extra[Name('PageLabels')] = series_to_pagelabels(runs)

    def write_toc(self, toc):
        """Outline tree from scandata TOC entries
        (``pdfhacks.py:227-237``).  toc: [{'title', 'level',
        'accessible-page'}] with 0-based page indices."""
        if not toc:
            return
        outlines_ref = self.w.reserve()
        item_refs = [self.w.reserve() for _ in toc]
        # flat outline (level nesting collapsed like fitz set_toc level-1s)
        for i, entry in enumerate(toc):
            page_idx = min(max(entry['accessible-page'], 0),
                           len(self.pages) - 1)
            item = {
                Name('Title'): entry['title'],
                Name('Parent'): outlines_ref,
                Name('Dest'): [self.pages[page_idx].ref, Name('XYZ'),
                               None, None, None],
            }
            if i > 0:
                item[Name('Prev')] = item_refs[i - 1]
            if i + 1 < len(toc):
                item[Name('Next')] = item_refs[i + 1]
            self.w.set(item_refs[i], item)
        self.w.set(outlines_ref, {
            Name('Type'): Name('Outlines'),
            Name('First'): item_refs[0],
            Name('Last'): item_refs[-1],
            Name('Count'): len(toc),
        })
        self.catalog_extra[Name('Outlines')] = outlines_ref

    def write_basic_ua(self, language=None):
        """Minimal accessibility scaffolding (``pdfhacks.py:240-400``):
        one /Figure structure element per page, a parent tree, viewer
        preferences, /MarkInfo and /Lang."""
        root_ref = self.w.reserve()
        parenttree_ref = self.w.reserve()
        elem_refs = []
        nums = []
        for idx, page in enumerate(self.pages):
            attr_ref = self.w.add({
                Name('O'): Name('Layout'),
                Name('Placement'): Name('Block'),
                Name('InlineAlign'): Name('Center'),
                Name('BBox'): [0, 0, int(page.width), int(page.height)],
            })
            elem_ref = self.w.add({
                Name('S'): Name('Figure'),
                Name('P'): root_ref,
                Name('Pg'): page.ref,
                Name('K'): 0,
                Name('A'): attr_ref,
            })
            elem_refs.append(elem_ref)
            kid_ref = self.w.add([elem_ref])
            nums.extend([idx, kid_ref])
            page.extra[Name('StructParents')] = idx
            page.extra[Name('Tabs')] = Name('S')
            page.extra[Name('Rotate')] = 0
            page.extra[Name('CropBox')] = [0, 0, page.width, page.height]
        self.w.set(parenttree_ref, {Name('Nums'): nums})
        self.w.set(root_ref, {
            Name('Type'): Name('StructTreeRoot'),
            Name('K'): elem_refs,
            Name('ParentTree'): parenttree_ref,
        })
        self.catalog_extra[Name('StructTreeRoot')] = root_ref
        self.catalog_extra[Name('MarkInfo')] = {Name('Marked'): True}
        self.catalog_extra[Name('ViewerPreferences')] = {
            Name('FitWindow'): True, Name('DisplayDocTitle'): True}
        if language:
            self.catalog_extra[Name('Lang')] = language

    def write_metadata(self, extra_metadata=None, from_docinfo=None,
                       from_xmp=None):
        """Docinfo + XMP (``pdfhacks.py:403-529``).  extra_metadata keys:
        url/title/author/creator/subject/creatortool/language."""
        md = dict(from_docinfo or {})
        extra = extra_metadata or {}
        md['producer'] = PRODUCER
        if 'url' in extra:
            md['keywords'] = extra['url']
        for k in ('title', 'author', 'creator', 'subject'):
            if k in extra:
                md[k] = extra[k]

        info_map = {'title': 'Title', 'author': 'Author',
                    'subject': 'Subject', 'keywords': 'Keywords',
                    'creator': 'Creator', 'producer': 'Producer'}
        for k, pdfk in info_map.items():
            if md.get(k):
                self.info[Name(pdfk)] = md[k]
        now = _pdf_date()
        cdate = md.get('creationDate') or now
        self.info[Name('CreationDate')] = cdate
        self.info[Name('ModDate')] = now

        if from_xmp is not None:
            self.xmp = from_xmp
            return

        iso_now = _now().strftime('%Y-%m-%dT%H:%M:%SZ')
        # XMP CreateDate must equal Info /CreationDate (PDF/A metadata
        # consistency) — when the date is carried over from a source
        # document (--from-pdf preserves it, like the reference), the
        # XMP stamp must derive from that value, not from the clock:
        # stamping 'now' here failed validation whenever the recode
        # took more than a second (caught 2026-08-20 by the strict
        # validator on a slow CPU run)
        import re as _re
        m = _re.match(r'D:(\d{4})(\d{2})(\d{2})(\d{2})(\d{2})(\d{2})',
                      cdate)
        create_iso = ('%s-%s-%sT%s:%s:%sZ' % m.groups()) if m else iso_now
        parts = ['''<?xpacket begin="﻿" id="W5M0MpCehiHzreSzNTczkc9d"?>
<x:xmpmeta xmlns:x="adobe:ns:meta/">
  <rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#">
    <rdf:Description rdf:about="" xmlns:xmp="http://ns.adobe.com/xap/1.0/">
      <xmp:CreateDate>%s</xmp:CreateDate>
      <xmp:MetadataDate>%s</xmp:MetadataDate>
      <xmp:ModifyDate>%s</xmp:ModifyDate>
      <xmp:CreatorTool>%s</xmp:CreatorTool>
    </rdf:Description>
    <rdf:Description rdf:about="" xmlns:pdf="http://ns.adobe.com/pdf/1.3/">'''
                 % (create_iso, iso_now, iso_now,
                    xmlescape(extra.get('creatortool', PRODUCER)))]
        if 'url' in extra:
            parts.append('\n      <pdf:Keywords>%s</pdf:Keywords>'
                         % xmlescape(extra['url']))
        parts.append('\n      <pdf:Producer>%s</pdf:Producer>'
                     % xmlescape(PRODUCER))
        parts.append('''
    </rdf:Description>
    <rdf:Description rdf:about="" xmlns:dc="http://purl.org/dc/elements/1.1/">''')
        if extra.get('title'):
            parts.append('''
      <dc:title><rdf:Alt><rdf:li xml:lang="x-default">%s</rdf:li></rdf:Alt></dc:title>'''
                         % xmlescape(extra['title']))
        if extra.get('author'):
            parts.append('''
      <dc:creator><rdf:Seq><rdf:li>%s</rdf:li></rdf:Seq></dc:creator>'''
                         % xmlescape(extra['author']))
        if extra.get('language'):
            langs = extra['language']
            if isinstance(langs, str):
                langs = [langs]
            parts.append('\n      <dc:language><rdf:Bag>')
            for lang in langs:
                parts.append('<rdf:li>%s</rdf:li>' % xmlescape(lang))
            parts.append('</rdf:Bag></dc:language>')
        parts.append('''
    </rdf:Description>
    <rdf:Description rdf:about="" xmlns:pdfaid="http://www.aiim.org/pdfa/ns/id/">
      <pdfaid:part>3</pdfaid:part>
      <pdfaid:conformance>B</pdfaid:conformance>
    </rdf:Description>
  </rdf:RDF>
</x:xmpmeta>
<?xpacket end="r"?>''')
        self.xmp = ''.join(parts)

    # ---- save ------------------------------------------------------------

    def _build_page_objects(self, deflate=True):
        kid_refs = []
        for page in self.pages:
            ops = [b'']
            resources = {
                Name('ProcSet'): [Name('PDF'), Name('Text'), Name('ImageB'),
                                  Name('ImageI'), Name('ImageC')],
                Name('Font'): {Name('f-0-0'): self.font_ref},
            }
            if page.images:
                xdict = {}
                for name, ref in page.images:
                    xdict[Name(name)] = ref
                    ops.append(b'q %s 0 0 %s 0 0 cm /%s Do Q\n' % (
                        (b'%g' % page.width), (b'%g' % page.height),
                        name.encode('ascii')))
                resources[Name('XObject')] = xdict
            if page.extra_ops:
                ops.append(page.extra_ops + b'\n')
            ops.append(page.text_ops)
            content_ref = self.w.add(Stream({}, b''.join(ops),
                                            deflate=deflate))
            d = {
                Name('Type'): Name('Page'),
                Name('Parent'): self.pages_ref,
                Name('MediaBox'): [0, 0, page.width, page.height],
                Name('Contents'): content_ref,
                Name('Resources'): resources,
            }
            d.update(page.extra)
            self.w.set(page.ref, d)
            kid_refs.append(page.ref)
        self.w.set(self.pages_ref, {
            Name('Type'): Name('Pages'),
            Name('Kids'): kid_refs,
            Name('Count'): len(kid_refs),
        })

    def save(self, path_or_fp, deflate=True):
        self._build_page_objects(deflate=deflate)
        catalog = {Name('Type'): Name('Catalog'),
                   Name('Pages'): self.pages_ref}
        catalog.update(self.catalog_extra)
        if self.xmp is not None:
            xmp_ref = self.w.add(Stream(
                {Name('Type'): Name('Metadata'),
                 Name('Subtype'): Name('XML')},
                self.xmp.encode('utf-8')))
            catalog[Name('Metadata')] = xmp_ref
        self.w.set(self.catalog_ref, catalog)
        info_ref = self.w.add(self.info)

        import hashlib
        doc_id = hashlib.md5(repr(sorted(
            (str(k), str(v)) for k, v in self.info.items()
        )).encode()).digest()

        if isinstance(path_or_fp, (str, bytes)):
            with open(path_or_fp, 'wb') as fp:
                self.w.save(fp, self.catalog_ref, info_ref, doc_id)
        else:
            self.w.save(path_or_fp, self.catalog_ref, info_ref, doc_id)
