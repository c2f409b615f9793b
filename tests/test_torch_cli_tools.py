"""The port's compress-pdf-images and pdfcomp (``--device cpu``) held
against the JAX package's, on the cases of ``tests/test_cli_tools.py``:
the same pages, image names, filters and sizes, the same JPEG2000
layers, and masks that decode to the JAX tools' bits.

The ``jpeg_pdf`` source (noisy ``make_book`` pages through JPEG) gives
one image a noise estimate above 1, where the blur's real taps enter:
the port's blur order (``csrc/blur_sauvola.cu``'s, ROADMAP C2) and
XLA's then differ in a few float sums, so its masks are held to 0.9999
agreement there and bit for bit everywhere else.  On a noise-free JPEG
source every mask is bit-equal.
"""

import os
import subprocess
import sys

import pytest
import torch

from archive_pdf_tools_tpu.cli.compress_pdf_images import main as jax_comp
from archive_pdf_tools_tpu.cli.pdfcomp import main as jax_pdfcomp
from archive_pdf_tools_tpu.codecs.jbig2 import decode_jbig2
from archive_pdf_tools_tpu.pdf.reader import PdfReader
from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
from archive_pdf_tools_tpu.validators.pdfa_check import StrictPdf

from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import \
    main as comp_main
from archive_pdf_tools_tpu_torch.cli.pdfcomp import main as pdfcomp_main

from tests.fixtures import make_book

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jpeg_source(tmp, noise):
    """Two pages, each an MRC stack of JPEG bg/fg and a CCITT mask (the
    ``jpeg_pdf`` fixture of tests/test_cli_tools.py), with ``noise`` as
    ``make_book``'s default or none."""
    stack, hocr, _ = make_book(tmp, n_pages=2, w=320, h=416)
    if not noise:
        from PIL import Image
        from tests.fixtures import render_book_page
        for i in range(2):
            img, _ = render_book_page(320, 416, seed=i, noise=0)
            Image.fromarray(img).save(str(tmp / ('page_%04d.png' % i)))
    out = str(tmp / 'src.pdf')
    jax_recode(from_imagestack=stack, hocr_file=hocr, out_pdf=out, dpi=100,
               jbig2=False, mask_compression='ccitt', mrc_image_format='jpeg',
               bg_compression_flags=['-S40'], fg_compression_flags=['-S30'])
    return out, hocr


@pytest.fixture(scope='module')
def jpeg_pdf(tmp_path_factory):
    return _jpeg_source(tmp_path_factory.mktemp('jpegsrc'), noise=True)


@pytest.fixture(scope='module')
def clean_pdf(tmp_path_factory):
    return _jpeg_source(tmp_path_factory.mktemp('cleansrc'), noise=False)


def _images(path):
    """Per page, per image: (name, filter, width, height, the stream's
    bytes, the decoded mask bits or None)."""
    rd = PdfReader(path)
    out = []
    for p in range(rd.page_count()):
        page = []
        for name, _, s in rd.page_images(p):
            w = int(rd.resolve(s.dict['Width']))
            h = int(rd.resolve(s.dict['Height']))
            bits = None
            if 'SMask' in s.dict:
                m = rd.resolve(s.dict['SMask'])
                bits = decode_jbig2(m.raw, int(rd.resolve(m.dict['Width'])),
                                    int(rd.resolve(m.dict['Height'])))
            page.append((name, str(rd.resolve(s.dict['Filter'])), w, h,
                         s.raw, bits))
        out.append(page)
    return out


def _held_to_jax(ours, ref, exact):
    a, b = _images(ours), _images(ref)
    assert len(a) == len(b) == 2
    for pa, pb in zip(a, b):
        assert [x[:4] for x in pa] == [x[:4] for x in pb]
        names = {x[0] for x in pa}
        assert 'MRCbg' in names and 'MRCfg' in names
        assert {x[1] for x in pa} == {'JPXDecode'}
        for xa, xb in zip(pa, pb):
            if xb[5] is None:
                continue
            agree = (xa[5] == xb[5]).mean()
            assert agree == 1.0 if exact else agree >= 0.9999, agree
    with open(ours, 'rb') as fp:
        StrictPdf(fp.read())          # test_cli_tools' _strict_parse


@pytest.mark.parametrize('hocr', [True, False])
def test_compress_pdf_images_matches_jax(jpeg_pdf, tmp_path, capsys, hocr):
    src, hocr_path = jpeg_pdf
    args = [src] + ([hocr_path] if hocr else [])
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    assert comp_main(args + [ours, '--dpi', '100', '--device', 'cpu']) == 0
    assert 'Compressed 2 pages' in capsys.readouterr().out
    assert jax_comp(args + [ref, '--dpi', '100']) == 0
    _held_to_jax(ours, ref, exact=False)


def test_compress_pdf_images_noise_free_masks_bit_equal(clean_pdf, tmp_path):
    src, hocr_path = clean_pdf
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    assert comp_main([src, hocr_path, ours, '--dpi', '100',
                      '--device', 'cpu']) == 0
    assert jax_comp([src, hocr_path, ref, '--dpi', '100']) == 0
    _held_to_jax(ours, ref, exact=True)
    # the JPEG2000 layers too
    for pa, pb in zip(_images(ours), _images(ref)):
        assert [x[4] for x in pa] == [x[4] for x in pb]


@pytest.mark.parametrize('hocr', [True, False])
def test_pdfcomp_matches_jax(jpeg_pdf, tmp_path, capsys, hocr):
    src, hocr_path = jpeg_pdf
    extra = ['--hocr', hocr_path] if hocr else []
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    assert pdfcomp_main([src, ours, '--device', 'cpu'] + extra) == 0
    assert 'Compression factor:' in capsys.readouterr().out
    assert jax_pdfcomp([src, ref] + extra) == 0
    _held_to_jax(ours, ref, exact=False)


@pytest.mark.parametrize('tool,args', [
    ('compress-pdf-images_torch', ['{src}', '{out}']),
    ('pdfcomp_torch', ['{src}', '{out}', '--hocr', '{hocr}'])])
def test_entry_point_runs_on_cpu_and_refuses_without_gpu(jpeg_pdf, tmp_path,
                                                         tool, args):
    src, hocr = jpeg_pdf
    out = str(tmp_path / 'o.pdf')
    cmd = [sys.executable, os.path.join(ROOT, 'bin', tool)] + [
        a.format(src=src, out=out, hocr=hocr) for a in args]
    env = dict(os.environ, OMP_NUM_THREADS='2')
    r = subprocess.run(cmd + ['--device', 'cpu'], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert PdfReader(out).page_count() == 2
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode != 0
        assert 'no CUDA device' in r.stderr
