"""The port's ElementTree scandata.xml reader held equal to the JAX
package's lxml reader, and ``recode(scandata_file=...)`` of the port held
byte-identical with the JAX package's."""

import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.const import PRODUCER as JAX_PRODUCER
from archive_pdf_tools_tpu.inputs import scandata as lxml_scandata
from archive_pdf_tools_tpu.pdf.reader import PdfReader
from archive_pdf_tools_tpu.validators import validate_pdfa

from archive_pdf_tools_tpu_torch.inputs import scandata as port_scandata
# the name the port's builder stamps (the port's const.PRODUCER), set to
# the JAX one where the two outputs are compared byte for byte
from archive_pdf_tools_tpu_torch.pdf import builder as port_builder

from tests.fixtures import (HOCR_TEMPLATE, make_scandata, render_book_page,
                            words_to_hocr_page)

torch.set_num_threads(2)

NAMESPACED = '''<?xml version="1.0" encoding="UTF-8"?>
<!-- a scanner's book -->
<sd:book xmlns:sd="http://archive.org/scribe/xml" xmlns:x="urn:x">
  <sd:bookData><sd:dpi>%(dpi)s</sd:dpi><x:note>n</x:note></sd:bookData>
  <sd:pageData>
    <sd:page leafNum="0"><sd:pageType>Cover</sd:pageType>
      <sd:addToAccessFormats>false</sd:addToAccessFormats>
      <sd:ppi>300</sd:ppi></sd:page>
    <sd:page leafNum="1"><!-- title leaf -->
      <sd:pageType title="Title page" level="1" label="i">Title</sd:pageType>
      <sd:pageNumber>i</sd:pageNumber>
      <sd:addToAccessFormats>true</sd:addToAccessFormats>
      <sd:ppi>300</sd:ppi></sd:page>
    <sd:page leafNum="2">
      <sd:pageType title="Chapter 1">Normal</sd:pageType>
      <x:pageNumber>iii</x:pageNumber>
      <sd:ppi>400</sd:ppi></sd:page>
    <sd:page leafNum="3"><sd:pageType>Normal</sd:pageType>
      <sd:pageNumber>2</sd:pageNumber></sd:page>
  </sd:pageData>
</sd:book>
'''


def _namespaced(tmp_path, dpi):
    path = tmp_path / 'scandata_ns.xml'
    path.write_text(NAMESPACED % {'dpi': dpi})
    return str(path)


@pytest.mark.parametrize('kind', ['e2e', 'namespaced', 'bad_dpi'])
def test_scandata_reader_matches_lxml_reader(tmp_path, kind):
    if kind == 'e2e':      # the scandata of tests/test_recode_e2e.py:108
        path = make_scandata(tmp_path, 3, dpi=100, skip=(1,),
                             numbers=[None, None, '5'])
    else:
        path = _namespaced(tmp_path, 'x' if kind == 'bad_dpi' else 300)
    ours, ref = port_scandata.Scandata(path), lxml_scandata.Scandata(path)
    for fn in ('skip_pages', 'page_numbers', 'dpi_per_page',
               'document_dpi', 'toc'):
        assert getattr(ours, fn)() == getattr(ref, fn)(), fn
    if kind == 'e2e':
        assert ours.skip_pages() == [1]
        assert ours.page_numbers() == [None, '5']
    elif kind == 'namespaced':
        assert ours.document_dpi() == 300
        assert [t['title'] for t in ours.toc()] == ['Title page',
                                                    'Chapter 1']
    else:
        assert ours.document_dpi() is None


def test_recode_with_scandata_byte_identical_with_jax(tmp_path,
                                                      monkeypatch):
    """Skip page, per-page DPI, page labels: the port's PDF is the JAX
    package's."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    hocr = []
    for i in range(3):
        img, words = render_book_page(320, 416, seed=i, noise=0)
        Image.fromarray(img).save(str(tmp_path / ('page_%04d.png' % i)))
        hocr.append(words_to_hocr_page(words, 320, 416, page_no=i))
    (tmp_path / 'book.hocr').write_text(HOCR_TEMPLATE % '\n'.join(hocr))
    sd = make_scandata(tmp_path, 3, dpi=100, skip=(1,),
                       numbers=[None, None, '5'])
    kw = dict(from_imagestack=str(tmp_path / 'page_*.png'),
              hocr_file=str(tmp_path / 'book.hocr'), scandata_file=sd,
              jbig2=True)
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    recode(out_pdf=ours, device='cpu', **kw)
    jax_recode(out_pdf=ref, **kw)
    validate_pdfa(ours)
    rd = PdfReader(ours)
    assert rd.page_count() == 2 and 'PageLabels' in rd.catalog
    with open(ours, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
