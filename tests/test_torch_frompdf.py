"""``recode(from_pdf=...)`` of the PyTorch port held against the JAX
package's: its copy of the page-image decoder, whole-page rendering of
multi-image pages, the CLI's hOCR extraction without ``-T``, and the
Producer stamp on XMP carried over from the source.

SOURCE_DATE_EPOCH pins the timestamps and the port's Producer is set to
the JAX package's where bytes are compared.  Byte identity holds where
the decoded pages get identity blur taps (noise-free lossless sources);
a JPEG source can give real taps, so there the decoded pages must be
equal and the masks agree to the K3 bar (>= 0.9999).
"""

import io
import os
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.codecs.ccitt import encode_ccitt_g4
from archive_pdf_tools_tpu.codecs.jbig2 import decode_jbig2, encode_jbig2
from archive_pdf_tools_tpu.const import PRODUCER as JAX_PRODUCER
from archive_pdf_tools_tpu.pdf.reader import PdfReader
from archive_pdf_tools_tpu.pdf.writer import Name, PdfWriter, Stream
from archive_pdf_tools_tpu.validators import validate_pdfa

import archive_pdf_tools_tpu_torch
# the name the port's builder stamps (the port's const.PRODUCER), set to
# the JAX one where the two outputs are compared byte for byte
from archive_pdf_tools_tpu_torch.pdf import builder as port_builder
from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader as PortReader
from archive_pdf_tools_tpu_torch.pipeline import recode as port_recode

from tests.fixtures import (HOCR_TEMPLATE, make_book, render_book_page,
                            words_to_hocr_page)

torch.set_num_threads(2)

W, H, DPI = 320, 416, 100
PT = 72.0 / DPI                    # PDF units per pixel at 100 DPI


def _image(w, h, data, bpc=8, cs='DeviceGray', filt='FlateDecode',
           **extra):
    d = {Name('Type'): Name('XObject'), Name('Subtype'): Name('Image'),
         Name('Width'): w, Name('Height'): h,
         Name('BitsPerComponent'): bpc, Name('ColorSpace'): Name(cs),
         Name('Filter'): Name(filt)}
    d.update({Name(k): v for k, v in extra.items()})
    return d, data


def _flate(arr):
    arr = np.asarray(arr)
    if arr.dtype == bool:
        return _image(arr.shape[1], arr.shape[0],
                      zlib.compress(np.packbits(arr, axis=1).tobytes()),
                      bpc=1)
    return _image(arr.shape[1], arr.shape[0], zlib.compress(arr.tobytes()),
                  cs='DeviceRGB' if arr.ndim == 3 else 'DeviceGray')


def _write_pdf(path, pages):
    """pages: [[(image dict, data, (x, y, w, h) in pixels), ...], ...] on
    W x H pixel pages at DPI; each image drawn into its box."""
    wr = PdfWriter()
    catalog, pages_ref = wr.reserve(), wr.reserve()
    kids = []
    for images in pages:
        xobjs, ops = {}, []
        for i, (d, data, (x, y, w, h)) in enumerate(images):
            xobjs[Name('Im%d' % i)] = wr.add(Stream(d, data))
            ops.append(b'q %g 0 0 %g %g %g cm /Im%d Do Q'
                       % (w * PT, h * PT, x * PT, (H - y - h) * PT, i))
        content = wr.add(Stream({}, b'\n'.join(ops)))
        kids.append(wr.add({
            Name('Type'): Name('Page'), Name('Parent'): pages_ref,
            Name('MediaBox'): [0, 0, W * PT, H * PT],
            Name('Contents'): content,
            Name('Resources'): {Name('XObject'): xobjs}}))
    wr.set(pages_ref, {Name('Type'): Name('Pages'), Name('Kids'): kids,
                       Name('Count'): len(kids)})
    wr.set(catalog, {Name('Type'): Name('Catalog'),
                     Name('Pages'): pages_ref})
    with open(path, 'wb') as fp:
        wr.save(fp, catalog)
    return str(path)


def _book(tmp_path, n_pages=3, noise=0):
    """Noise-free pages (page 1 RGB) with their worded hOCR at DPI."""
    pages, hocr = [], []
    for i in range(n_pages):
        img, words = render_book_page(W, H, seed=i, noise=noise,
                                      rgb=i == 1)
        pages.append(img)
        hocr.append(words_to_hocr_page(words, W, H, page_no=i, dpi=DPI))
    path = tmp_path / 'book.hocr'
    path.write_text(HOCR_TEMPLATE % '\n'.join(hocr), encoding='utf-8')
    return pages, str(path)


def _masks(pdf):
    """Per page, the decoded JBIG2 mask (the SMask of the fg image, or
    the page's only image), True = ink."""
    rd = PdfReader(pdf)
    out = []
    for i in range(rd.page_count()):
        for _, _, im in rd.page_images(i):
            sm = rd.resolve(im.dict.get('SMask'))
            s = sm if sm is not None else im
            if str(rd.resolve(s.dict.get('Filter'))) != 'JBIG2Decode':
                continue
            out.append(~decode_jbig2(s.raw, int(rd.resolve(s.dict['Width'])),
                                     int(rd.resolve(s.dict['Height']))))
    return out


def _both(tmp_path, monkeypatch, src, hocr, **kw):
    """The port's and the JAX package's recode of one source, with the
    port's Producer set to the JAX one."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    res = archive_pdf_tools_tpu_torch.recode(
        from_pdf=src, hocr_file=hocr, out_pdf=ours, jbig2=True,
        device='cpu', **kw)
    jax_recode(from_pdf=src, hocr_file=hocr, out_pdf=ref, jbig2=True, **kw)
    validate_pdfa(ours)
    assert res['compression_ratio'] == pytest.approx(
        os.path.getsize(src) / os.path.getsize(ours))
    return ours, ref


FILTERS = ('dct_gray', 'dct_rgb', 'jpx', 'jbig2', 'jbig2_decode', 'ccitt',
           'ccitt_default', 'flate_rgb', 'flate_gray', 'flate_1bit')


def _filter_case(name):
    """(image dict, data, the pixels where the filter is lossless)."""
    rng = np.random.default_rng(5)
    gray = rng.integers(0, 256, (30, 41), dtype=np.uint8)
    rgb = rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
    bits = rng.random((30, 41)) < 0.3

    def pil(arr, fmt):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        return buf.getvalue()

    fax = {Name('K'): -1, Name('Columns'): 41, Name('Rows'): 30}
    if name == 'dct_gray':
        return _image(41, 30, pil(gray, 'JPEG'), filt='DCTDecode') + (None,)
    if name == 'dct_rgb':
        return _image(41, 30, pil(rgb, 'JPEG'), cs='DeviceRGB',
                      filt='DCTDecode') + (None,)
    if name == 'jpx':
        return _image(41, 30, pil(rgb, 'JPEG2000'), cs='DeviceRGB',
                      filt='JPXDecode') + (rgb,)
    if name.startswith('jbig2'):
        # jbig2 white is ink-opaque; /Decode [1 0] flips it
        extra = {'Decode': [1, 0]} if name == 'jbig2_decode' else {}
        return _image(41, 30, encode_jbig2(bits), bpc=1, filt='JBIG2Decode',
                      **extra) + (bits if extra else ~bits,)
    if name.startswith('ccitt'):
        if name == 'ccitt':
            fax[Name('BlackIs1')] = True
        return _image(41, 30, encode_ccitt_g4(bits), bpc=1,
                      filt='CCITTFaxDecode', DecodeParms=fax) + (None,)
    arr = {'flate_rgb': rgb, 'flate_gray': gray, 'flate_1bit': bits}[name]
    return _flate(arr) + (arr,)


@pytest.mark.parametrize('case', FILTERS)
def test_decode_pdf_image_matches_jax(tmp_path, case):
    from archive_pdf_tools_tpu.pipeline.recode import \
        _decode_pdf_image as jax_decode
    d, data, pixels = _filter_case(case)
    path = _write_pdf(tmp_path / 'f.pdf', [[(d, data, (0, 0, 41, 30))]])
    rd, prd = PdfReader(path), PortReader(path)
    (_, _, stream), = rd.page_images(0)
    (_, _, pstream), = prd.page_images(0)
    ours = port_recode._decode_pdf_image(prd, pstream)
    ref = jax_decode(rd, stream)
    assert ours.mode == ref.mode and ours.size == ref.size == (41, 30)
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    if pixels is not None:
        np.testing.assert_array_equal(np.asarray(ours), pixels)


def test_lossless_source_recodes_byte_identical_with_jax(tmp_path,
                                                         monkeypatch):
    """Flate pages: gray, RGB, and a page of two images (top and bottom
    halves) rendered whole."""
    pages, hocr = _book(tmp_path)
    half = H // 2
    src = _write_pdf(tmp_path / 'src.pdf', [
        [_flate(pages[0]) + ((0, 0, W, H),)],
        [_flate(pages[1]) + ((0, 0, W, H),)],
        [_flate(pages[2][:half]) + ((0, 0, W, half),),
         _flate(pages[2][half:]) + ((0, half, W, H - half),)]])
    ours, ref = _both(tmp_path, monkeypatch, src, hocr)
    with open(ours, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()
    # the two-image page was rendered back to its pixels
    img = port_recode._load_page_image(PortReader(src), None, 2, None,
                                       None, None, False, None)
    np.testing.assert_array_equal(np.asarray(img), pages[2])


def test_jpeg_mrc_source_with_jax(tmp_path, monkeypatch):
    """The source of tests/test_recode_e2e.py:172: an MRC PDF with JPEG
    layers and a CCITT mask, two images a page, so each page is
    rendered whole.  Decoded pages equal; masks to the K3 bar."""
    from archive_pdf_tools_tpu.pipeline import recode as jax_recode_mod
    stack, hocr, _ = make_book(tmp_path, n_pages=2, w=W, h=H)
    src = str(tmp_path / 'src.pdf')
    jax_recode_mod.recode(from_imagestack=stack, hocr_file=hocr,
                          out_pdf=src, dpi=DPI, jbig2=False,
                          mrc_image_format='jpeg', image_mode=2,
                          mask_compression='ccitt',
                          bg_compression_flags=['-S40'],
                          fg_compression_flags=['-S30'])
    rd, prd = PdfReader(src), PortReader(src)
    for i in range(2):
        assert len(rd.page_images(i)) == 2
        args = (None, i, None, None, None, False, None)
        ours = port_recode._load_page_image(prd, *args)
        ref = jax_recode_mod._load_page_image(rd, *args)
        assert ours.mode == ref.mode
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(ref))
    ours, ref = _both(tmp_path, monkeypatch, src, hocr)
    mo, mr = _masks(ours), _masks(ref)
    assert len(mo) == len(mr) == 2
    for a, b in zip(mo, mr):
        assert a.shape == b.shape == (H, W)
        assert (a == b).mean() >= 0.9999
        assert 0.005 < a.mean() < 0.6


def test_bitonal_jbig2_source_gives_a_mask_only_page(tmp_path,
                                                     monkeypatch):
    """The source of tests/test_recode_e2e.py:275 (a --bw-pdf output: one
    JBIG2 image a page) recodes to a mask-only page, byte-identical."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    stack, hocr, _ = make_book(tmp_path, n_pages=1, w=W, h=H)
    src = str(tmp_path / 'bw.pdf')
    jax_recode(from_imagestack=stack, hocr_file=hocr, out_pdf=src, dpi=DPI,
               jbig2=True, force_1bit_output=True)
    ours, ref = _both(tmp_path, monkeypatch, src, hocr)
    assert len(PdfReader(ours).page_images(0)) == 1
    with open(ours, 'rb') as a, open(ref, 'rb') as b:
        assert a.read() == b.read()


def test_cli_from_pdf_without_hocr_file(tmp_path, monkeypatch):
    """Without -T the CLI extracts the source's own text layer as hOCR;
    the port's and the JAX CLI's outputs carry the same text layer, page
    sizes and masks."""
    from archive_pdf_tools_tpu.cli.recode_pdf import main as jax_main
    from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    pages, hocr = _book(tmp_path, n_pages=2)
    for i, page in enumerate(pages):
        Image.fromarray(page).save(str(tmp_path / ('page_%04d.png' % i)))
    src = str(tmp_path / 'src.pdf')
    # the port's own MRC output: two images and a text layer a page
    archive_pdf_tools_tpu_torch.recode(
        from_imagestack=str(tmp_path / 'page_*.png'), hocr_file=hocr,
        out_pdf=src, dpi=DPI, jbig2=True, device='cpu')
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    common = ['--from-pdf', src, '--threads', '2', '-v']
    assert main(common + ['-o', ours, '--device', 'cpu']) == 0
    assert jax_main(common + ['-o', ref]) == 0
    validate_pdfa(ours)
    ro, rr = PdfReader(ours), PdfReader(ref)
    assert ro.page_count() == rr.page_count() == 2
    for i in range(2):
        assert ro.page_size(i) == rr.page_size(i)
        text = ro.page_contents(i)
        assert b'3 Tr' in text and b'TJ' in text
        assert text == rr.page_contents(i)
        assert len(ro.page_images(i)) == 2
    for a, b in zip(_masks(ours), _masks(ref)):
        assert (a == b).mean() >= 0.9999


def _pillow_source(tmp_path, pages):
    path = str(tmp_path / 'pil.pdf')
    ims = [Image.fromarray(p) for p in pages]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                resolution=DPI)
    return path


@pytest.mark.parametrize('writer', ['jax', 'torch', 'pillow'])
def test_producer_on_carried_over_xmp(tmp_path, monkeypatch, writer):
    """--from-pdf carries the source's XMP over verbatim.  The port's
    output equals the JAX recode()'s on the same source with the JAX
    Producer swapped for the port's: in Info always, in the XMP at each
    occurrence (two in a JAX-written source, none in a port-written
    one; Pillow writes no XMP, so the builder's own is stamped).  It
    never raises and is valid PDF/A.  (On the port-written source the
    JAX output names the JAX engine in Info but the port in the carried
    XMP, which the validator refuses; the port's output agrees.)"""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    ours_p = archive_pdf_tools_tpu_torch.PRODUCER
    pages, hocr = _book(tmp_path, n_pages=2)
    if writer == 'pillow':
        src = _pillow_source(tmp_path, pages)
    else:
        for i, page in enumerate(pages):
            Image.fromarray(page).save(str(tmp_path / ('p_%04d.png' % i)))
        src = str(tmp_path / 'src.pdf')
        kw = dict(from_imagestack=str(tmp_path / 'p_*.png'), hocr_file=hocr,
                  out_pdf=src, dpi=DPI, jbig2=True)
        if writer == 'jax':
            jax_recode(**kw)
        else:
            archive_pdf_tools_tpu_torch.recode(device='cpu', **kw)
    src_xmp = PdfReader(src).xmp_metadata()
    assert (src_xmp is None) == (writer == 'pillow')
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    archive_pdf_tools_tpu_torch.recode(from_pdf=src, hocr_file=hocr,
                                       out_pdf=ours, jbig2=True,
                                       device='cpu')
    jax_recode(from_pdf=src, hocr_file=hocr, out_pdf=ref, jbig2=True)
    validate_pdfa(ours)
    if writer != 'torch':
        validate_pdfa(ref)
    ro, rr = PdfReader(ours), PdfReader(ref)
    assert ro.info()['Producer'] == ours_p.encode()
    assert rr.info()['Producer'] == JAX_PRODUCER.encode()
    xo, xr = ro.xmp_metadata().decode(), rr.xmp_metadata().decode()
    assert xo == xr.replace(JAX_PRODUCER, ours_p)
    assert JAX_PRODUCER not in xo
    # pdf:Producer and xmp:CreatorTool
    assert xr.count(JAX_PRODUCER) == (0 if writer == 'torch' else 2)
    assert xo.count(ours_p) == 2
    if writer != 'pillow':
        assert xr == src_xmp.decode()             # carried over verbatim
    assert ro.info()['CreationDate'] == rr.info()['CreationDate']
