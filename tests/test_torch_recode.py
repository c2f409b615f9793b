"""The PyTorch port's recode() and CLI held against the JAX package's.

SOURCE_DATE_EPOCH pins the emitted timestamps and the port's Producer is
set to the JAX package's, so on a noise-free book (with or without hOCR
words; its line boxes do not overlap) the two pipelines must write the
same bytes.
"""

import os
import subprocess
import sys

import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.const import PRODUCER as JAX_PRODUCER
from archive_pdf_tools_tpu.inputs import hocr as jax_hocr
from archive_pdf_tools_tpu.pdf.reader import PdfReader
from archive_pdf_tools_tpu.validators import validate_pdfa

import archive_pdf_tools_tpu_torch
# the name the port's builder stamps (the port's const.PRODUCER), set to
# the JAX one where the two outputs are compared byte for byte
from archive_pdf_tools_tpu_torch.pdf import builder as port_builder
from archive_pdf_tools_tpu_torch.pipeline import recode as port_recode

from archive_pdf_tools_tpu_torch.inputs import hocr as port_hocr

from tests.fixtures import (HOCR_TEMPLATE, make_book, render_book_page,
                            words_to_hocr_page)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_word_book(tmp_path, n_pages=3, mode='L', words=False):
    """Noise-free pages with empty hOCR (or, with ``words``, the words
    drawn); page 1 in ``mode``."""
    hocr = []
    for i in range(n_pages):
        img, wds = render_book_page(320, 416, seed=i, noise=0,
                                    rgb=i == 1 and mode == 'RGB')
        im = Image.fromarray(img)
        if i == 1 and mode == '1':
            im = im.convert('1')
        im.save(str(tmp_path / ('page_%04d.png' % i)))
        hocr.append(words_to_hocr_page(wds if words else [], 320, 416,
                                       page_no=i, dpi=100))
    hocr_path = tmp_path / 'book.hocr'
    hocr_path.write_text(HOCR_TEMPLATE % '\n'.join(hocr), encoding='utf-8')
    return str(tmp_path / 'page_*.png'), str(hocr_path)


def _image_sizes(pdf):
    """Per page, the sorted (width, height) of its image XObjects."""
    rd = PdfReader(pdf)
    return [sorted((int(rd.resolve(im.dict['Width'])),
                    int(rd.resolve(im.dict['Height'])))
                   for _, _, im in rd.page_images(i))
            for i in range(rd.page_count())]


def _as_text(v):
    return v.decode() if isinstance(v, bytes) else str(v)


@pytest.mark.parametrize('mode,image_mode', [('L', 2), ('RGB', 2),
                                             ('1', 2), ('L', 3)])
def test_recode_byte_identical_with_jax(tmp_path, monkeypatch, mode,
                                        image_mode):
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    glob_pat, hocr_path = _no_word_book(tmp_path, mode=mode)
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              jbig2=True, image_mode=image_mode)
    res = recode(out_pdf=str(ours), device='cpu', **kw)
    jax_recode(out_pdf=str(ref), **kw)
    assert res['compression_ratio'] > 0
    validate_pdfa(str(ours))
    assert ours.read_bytes() == ref.read_bytes()


def test_worded_book_byte_identical_with_jax(tmp_path, monkeypatch):
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    glob_pat, hocr_path = _no_word_book(tmp_path, mode='RGB', words=True)
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              jbig2=True)
    recode(out_pdf=str(ours), device='cpu', **kw)
    jax_recode(out_pdf=str(ref), **kw)
    validate_pdfa(str(ours))
    assert ours.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize('n_pages,mode,extra', [
    (3, 'RGB', {}), (3, 'RGB', {'hq_pages': '2'}),
    (3, 'RGB', {'hq_pages': '1,2,3'}), (5, 'L', {})])
def test_tpu_recode_byte_identical_with_jax(tmp_path, monkeypatch, n_pages,
                                            mode, extra):
    """-J tpu at its default flags (pack4 for fg and bg), with one HQ page
    in a mixed batch (encoded alone at the HQ ratios), with every page HQ
    (no batch transform), and on a 5-page book, which both pipelines
    split into batches of 3 and 2 (the pack shifts are per batch)."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    glob_pat, hocr_path = _no_word_book(tmp_path, n_pages=n_pages, mode=mode,
                                        words=True)
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              jbig2=True, jpeg2000_implementation='tpu', **extra)
    timing = []
    monkeypatch.setattr(port_recode, 'get_timing_summary',
                        lambda t: timing.extend(t) or {})
    recode(out_pdf=str(ours), device='cpu', verbose=True, **kw)
    jax_recode(out_pdf=str(ref), **kw)
    validate_pdfa(str(ours))
    assert ours.read_bytes() == ref.read_bytes()
    keys = {k for k, _ in timing}
    assert {'fg_jp2', 'bg_jp2'} <= keys
    assert ('jp2_batch_transform' in keys) == (extra.get('hq_pages')
                                               != '1,2,3')


def test_tpu_bg_downsample_matches_jax_sizes(tmp_path):
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    glob_pat, hocr_path = _no_word_book(tmp_path, words=True)
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              jpeg2000_implementation='tpu', bg_downsample=3)
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    recode(out_pdf=ours, device='cpu', **kw)
    validate_pdfa(ours)
    jax_recode(out_pdf=ref, **kw)
    sizes = _image_sizes(ours)
    assert sizes == _image_sizes(ref)
    assert all((106, 138) in page for page in sizes)


def test_reference_producer_is_the_jax_engine_name():
    """The port swaps the JAX engine's name out of a carried-over XMP by
    its own copy of that name."""
    from archive_pdf_tools_tpu_torch import const
    assert const.REFERENCE_PRODUCER == JAX_PRODUCER
    assert const.PRODUCER == archive_pdf_tools_tpu_torch.PRODUCER
    assert port_builder.PRODUCER == const.PRODUCER


def test_producer_names_the_torch_engine(tmp_path, monkeypatch):
    from archive_pdf_tools_tpu_torch import recode
    glob_pat, hocr_path = _no_word_book(tmp_path, n_pages=1, words=True)
    out = tmp_path / 'o.pdf'
    recode(from_imagestack=glob_pat, hocr_file=hocr_path, out_pdf=str(out),
           dpi=100, jbig2=True, device='cpu')
    validate_pdfa(str(out))
    ours = archive_pdf_tools_tpu_torch.PRODUCER
    assert 'PyTorch' in ours and ours != JAX_PRODUCER
    rd = PdfReader(str(out))
    assert _as_text(rd.info()['Producer']) == ours
    xmp = _as_text(rd.xmp_metadata())
    assert '<pdf:Producer>%s</pdf:Producer>' % ours in xmp
    assert '<xmp:CreatorTool>%s</xmp:CreatorTool>' % ours in xmp
    assert JAX_PRODUCER not in xmp
    # a CreatorTool the caller gives is kept
    recode(from_imagestack=glob_pat, hocr_file=hocr_path, out_pdf=str(out),
           dpi=100, jbig2=True, device='cpu', metadata_creatortool='scanner')
    xmp = _as_text(PdfReader(str(out)).xmp_metadata())
    assert '<xmp:CreatorTool>scanner</xmp:CreatorTool>' in xmp
    assert '<pdf:Producer>%s</pdf:Producer>' % ours in xmp
    validate_pdfa(str(out))


def test_bg_downsample_cli_matches_jax_dims(tmp_path):
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    glob_pat, hocr_path = _no_word_book(tmp_path, n_pages=2, words=True)
    out = tmp_path / 'cli.pdf'
    cmd = [sys.executable, os.path.join(ROOT, 'bin', 'recode_pdf_torch'),
           '--from-imagestack', glob_pat, '--hocr-file', hocr_path,
           '--dpi', '100', '-o', str(out), '--threads', '2',
           '--bg-downsample', '3', '--device', 'cpu']
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert r.returncode == 0, r.stderr[-2000:]
    validate_pdfa(str(out))
    ref = tmp_path / 'jax.pdf'
    jax_recode(from_imagestack=glob_pat, hocr_file=hocr_path,
               out_pdf=str(ref), dpi=100, bg_downsample=3)
    sizes = _image_sizes(str(out))
    assert sizes == _image_sizes(str(ref))
    assert all((106, 138) in page for page in sizes)   # 320x416 / 3


def test_hq_page_keeps_full_layers_in_a_downsampled_batch(tmp_path):
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    glob_pat, hocr_path = _no_word_book(tmp_path, words=True)
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              bg_downsample=3, fg_downsample=2, hq_pages='2')
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    recode(out_pdf=ours, device='cpu', **kw)
    validate_pdfa(ours)
    jax_recode(out_pdf=ref, **kw)
    sizes = _image_sizes(ours)
    assert sizes == _image_sizes(ref)
    assert sizes[1] == [(320, 416), (320, 416)]     # the HQ page: bg, fg
    assert sizes[0] == [(106, 138), (160, 208)]


def test_resume_from_out_dir_gives_same_bytes(tmp_path, monkeypatch):
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    glob_pat, hocr_path = _no_word_book(tmp_path)
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              jbig2=True, device='cpu', out_dir=str(tmp_path / 'parts'))
    recode(out_pdf=str(tmp_path / 'a.pdf'), **kw)
    assert len(os.listdir(tmp_path / 'parts')) == 3 * 4
    recode(out_pdf=str(tmp_path / 'b.pdf'), resume=True, **kw)
    assert ((tmp_path / 'a.pdf').read_bytes()
            == (tmp_path / 'b.pdf').read_bytes())


def test_cli_recodes_on_cpu_and_refuses_without_gpu(tmp_path):
    glob_pat, hocr_path = _no_word_book(tmp_path, n_pages=2)
    out = tmp_path / 'cli.pdf'
    cmd = [sys.executable, os.path.join(ROOT, 'bin', 'recode_pdf_torch'),
           '--from-imagestack', glob_pat, '--hocr-file', hocr_path,
           '--dpi', '100', '-o', str(out), '--threads', '2']
    env = dict(os.environ, OMP_NUM_THREADS='2')
    r = subprocess.run(cmd + ['--device', 'cpu'], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    validate_pdfa(str(out))
    if not torch.cuda.is_available():
        # the default device is the GPU; no silent fall-back to the CPU
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode != 0
        assert 'no CUDA device' in r.stderr


@pytest.mark.parametrize('kw', [
    {'from_pdf': 'in.pdf', 'from_imagestack': None},
    {'jpeg2000_implementation': 'tpu'},
    {'grayscale_pdf': True},
    {'force_1bit_output': True},
    {'downsample': 2},
    {'bg_downsample': 3},
    {'fg_downsample': 2},
    {'jbig2_symbol_mode': True},
    {'jbig2_symbol_mode': 'auto'},
    {'jbig2_symbol_mode': 'lossy'},
    {'jbig2_symbol_mode': 'refine'},
    {'jbig2_bands': 2},
    {'exact_denoise': False},
    {'denoise_mask': 'bregman'},
    {'profile_dir': 'prof'},
    {'image_mode': 0, 'from_imagestack': None},
    {'image_mode': 1, 'from_imagestack': None},
    {'image_mode': 0, 'from_pdf': 'jpeg.pdf', 'from_imagestack': None},
    {'image_mode': 1, 'from_pdf': 'jpeg.pdf', 'from_imagestack': None},
])
def test_unported_options_raise(tmp_path, monkeypatch, kw):
    """Formerly: the options off the main path raised.  Every option
    of the JAX package's ``recode`` runs now, on a worded book with an
    RGB page (``from_pdf`` and image modes 0/1: the JAX package's MRC
    PDF of it, whose pages hold two images each and are rendered whole,
    or Pillow's PDF of one JPEG a page, passed through in mode 0), and
    gives
    the JAX package's PDF: the bytes, save where a layer shrinks on the
    device (whose float sums may differ by 1 LSB: the image sizes) and
    with bregman (the image sizes, and the masks at >= 0.9999 per page).
    ``profile_dir`` writes a Chrome trace and the same bytes."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    glob_pat, hocr_path = _no_word_book(tmp_path, n_pages=2, mode='RGB',
                                        words=True)
    args = dict(kw, from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
                jbig2=True, out_pdf=str(tmp_path / 'o.pdf'))
    if 'from_imagestack' in kw:
        src = str(tmp_path / 'in.pdf')
        if kw.get('from_pdf') == 'jpeg.pdf':
            # one JPEG a page, written by Pillow
            ims = [Image.open(p) for p in sorted(tmp_path.glob('*.png'))]
            ims[0].save(src, save_all=True, append_images=ims[1:],
                        resolution=100)
            assert all(len(PdfReader(src).page_images(i)) == 1
                       for i in range(2))
        else:
            jax_recode(out_pdf=src, from_imagestack=glob_pat,
                       hocr_file=hocr_path, dpi=100, jbig2=True)
        args.update(from_pdf=src, from_imagestack=None, dpi=None)
    if 'profile_dir' in kw:
        args['profile_dir'] = str(tmp_path / 'prof')
    recode(device='cpu', **args)
    ref = str(tmp_path / 'jax.pdf')
    args.pop('profile_dir', None)
    jax_recode(**dict(args, out_pdf=ref))
    ours = args['out_pdf']
    validate_pdfa(ours)
    assert _image_sizes(ours) == _image_sizes(ref)
    if 'profile_dir' in kw:
        trace = tmp_path / 'prof' / 'trace.json'
        assert b'traceEvents' in trace.read_bytes()[:4096]
    if kw.get('denoise_mask') == 'bregman':
        for a, b in zip(_masks(ours), _masks(ref)):
            assert (a == b).mean() >= 0.9999
    if not any(k.endswith('_downsample') or k == 'denoise_mask'
               for k in kw):
        with open(ours, 'rb') as a, open(ref, 'rb') as b:
            assert a.read() == b.read()


def _masks(pdf):
    """Per page, the decoded bits of its JBIG2 masks (ink True)."""
    from archive_pdf_tools_tpu.codecs.jbig2 import decode_jbig2
    rd = PdfReader(pdf)
    out = []
    for i in range(rd.page_count()):
        for _, _, im in rd.page_images(i):
            m = rd.resolve(im.dict.get('SMask'))
            if m is None:
                continue
            out.append(decode_jbig2(m.raw, int(rd.resolve(m.dict['Width'])),
                                    int(rd.resolve(m.dict['Height']))))
    assert len(out) == rd.page_count()
    return out


@pytest.mark.parametrize('coding', ['off', 'on', 'auto', 'lossy', 'refine'])
def test_cli_symbol_coding_matches_jax_cli(tmp_path, monkeypatch, coding):
    """--jbig2-symbol-coding through both CLIs' main gives the same bytes:
    the port's CLI hands recode() the JAX CLI's True/'auto'/'lossy'/
    'refine' (it once collapsed every mode to True, so 'auto', 'lossy'
    and 'refine' coded as 'on')."""
    from archive_pdf_tools_tpu.cli.recode_pdf import main as jax_main
    from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    glob_pat, hocr_path = _no_word_book(tmp_path, n_pages=2, words=True)
    argv = ['--from-imagestack', glob_pat, '--hocr-file', hocr_path,
            '--dpi', '100', '--threads', '2', '--jbig2-symbol-coding', coding]
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    assert main(argv + ['-o', str(ours), '--device', 'cpu']) == 0
    assert jax_main(argv + ['-o', str(ref)]) == 0
    assert ours.read_bytes() == ref.read_bytes()


def test_book_with_words_raises(tmp_path):
    """Formerly: a book with hOCR words raised.  Now a noisy worded book
    (``make_book``) recodes to valid PDF/A with the JAX package's page
    and image sizes."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    glob_pat, hocr_path, _ = make_book(tmp_path, n_pages=2, w=320, h=416,
                                       dpi=100)
    out, ref = str(tmp_path / 'o.pdf'), str(tmp_path / 'jax.pdf')
    res = recode(from_imagestack=glob_pat, hocr_file=hocr_path,
                 out_pdf=out, dpi=100, device='cpu')
    validate_pdfa(out)
    assert res['compression_ratio'] > 1
    jax_recode(from_imagestack=glob_pat, hocr_file=hocr_path, out_pdf=ref,
               dpi=100)
    assert _image_sizes(out) == _image_sizes(ref)
    assert PdfReader(out).page_size(0) == PdfReader(ref).page_size(0)


def test_hocr_reader_matches_lxml_reader(tmp_path):
    _, hocr_path, _ = make_book(tmp_path, n_pages=3, w=320, h=416, dpi=150)
    ours = list(port_hocr.hocr_page_iterator(hocr_path))
    ref = list(jax_hocr.hocr_page_iterator(hocr_path))
    assert len(ours) == len(ref) == 3
    for a, b in zip(port_hocr.hocr_page_iterator(hocr_path),
                    jax_hocr.hocr_page_iterator(hocr_path)):
        assert (port_hocr.hocr_page_get_dimensions(a)
                == jax_hocr.hocr_page_get_dimensions(b))
        assert (port_hocr.hocr_page_get_scan_res(a)
                == jax_hocr.hocr_page_get_scan_res(b))
        for scaler in (1, 0.48):
            assert (port_hocr.hocr_page_to_word_data(a, scaler)
                    == jax_hocr.hocr_page_to_word_data(b, scaler))
