"""The port's debug tools (``archive_pdf_tools_tpu_torch/tools/``) and
its copies of the pdf-to-imagestack and pdfrenderer CLIs, held against
the root JAX tools and the JAX CLIs on the same inputs, at the bar of
``tests/test_cli_tools.py``: masks, fills and JPEG2000 bytes equal, and
the same listing, layer pages, image stack and text-only PDF.

The root tools run in this process (``runpy``), the port's with
``--device cpu``, which runs the plain versions of the kernels.
"""

import os
import runpy
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.cli.pdf_to_imagestack import main as jax_stack
from archive_pdf_tools_tpu.cli.pdfrenderer_cli import main as jax_render
from archive_pdf_tools_tpu.codecs.mrc_encode import (
    encode_mrc_background as jax_encode_bg,
    encode_mrc_foreground as jax_encode_fg)
from archive_pdf_tools_tpu.const import PRODUCER as JAX_PRODUCER
from archive_pdf_tools_tpu.ops import golden
from archive_pdf_tools_tpu.ops.optimise import optimise as jax_optimise

from archive_pdf_tools_tpu_torch.cli.pdf_to_imagestack import \
    main as port_stack
from archive_pdf_tools_tpu_torch.cli.pdfrenderer_cli import \
    main as port_render
from archive_pdf_tools_tpu_torch.pdf import builder as port_builder
from archive_pdf_tools_tpu_torch.pipeline.recode import recode
from archive_pdf_tools_tpu_torch.tools import (compress, mrcview,
                                               partial_blur, pdfimagesmrc,
                                               threshold_image)

from tests.fixtures import make_book, render_book_page

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J2K_BG = 'quality_mode:"rates";quality_layers:[500]'
J2K_FG = 'quality_mode:"rates";quality_layers:[750]'


def _jax_tool(monkeypatch, name, *args):
    """Run the root tool ``tools/<name>`` in this process."""
    path = os.path.join(ROOT, 'tools', name)
    with monkeypatch.context() as m:
        m.setattr(sys, 'argv', [path] + [str(a) for a in args])
        m.setattr(sys, 'path', list(sys.path))
        runpy.run_path(path, run_name='__main__')


def _port_tool(module, *args):
    assert module.main([str(a) for a in args] + ['--device', 'cpu']) == 0


@pytest.fixture(scope='module')
def page(tmp_path_factory):
    """A noisy rendered RGB page as a PNG."""
    tmp = tmp_path_factory.mktemp('page')
    img, _ = render_book_page(120, 160, rgb=True)
    Image.fromarray(img).save(str(tmp / 'in.png'))
    return tmp


@pytest.fixture(scope='module')
def book_pdf(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('book')
    stack, hocr, _ = make_book(tmp, n_pages=2)
    out = str(tmp / 'book.pdf')
    recode(from_imagestack=stack, hocr_file=hocr, out_pdf=out, dpi=100,
           jbig2=True, bg_compression_flags=[J2K_BG],
           fg_compression_flags=[J2K_FG], device='cpu')
    return out, hocr


def _mask(path):
    return np.asarray(Image.open(path).convert('1'))


@pytest.mark.parametrize('extra', [['--denoise', 'none'],
                                   ['--denoise', 'fast'],
                                   ['--denoise', 'fast', '--invert',
                                    '-k', '0.2']])
def test_threshold_image_matches_jax_tool(page, monkeypatch, extra):
    src = page / 'in.png'
    _jax_tool(monkeypatch, 'threshold-image', src, page / 'j.png', '--dpi',
              100, *extra)
    _port_tool(threshold_image, src, page / 't.png', '--dpi', 100, *extra)
    ref, got = _mask(page / 'j.png'), _mask(page / 't.png')
    assert got.any() and not got.all()
    assert (got == ref).all()


def _read_mask(path):
    """The mask as a canonical bool array.  The root tools pass Pillow's
    mode '1' array on, whose True bytes are 255: the JAX fill then
    counts each set pixel 255 times (its ``mask.astype(int32)``) and
    departs from its own oracle (``ops/golden.optimise_ref``); the
    port's tools read the mask as booleans (``tools/threshold_image.
    read_mask``), so they are held to the JAX functions on this mask."""
    return np.asarray(Image.open(path).convert('1')) != 0


@pytest.mark.parametrize('mode,n', [('optimise', 3), ('optimise', 10),
                                    ('gaussian', 3), ('box', 5)])
def test_partial_blur_matches_jax_tool(page, monkeypatch, mode, n):
    src, mask = page / 'in.png', page / 'mask.png'
    if not mask.exists():
        _jax_tool(monkeypatch, 'threshold-image', src, mask, '--dpi', 100,
                  '--denoise', 'fast')
    args = ['--mode', mode, '-n', n] + (['--invert-mask'] if n == 10
                                        else [])
    _port_tool(partial_blur, src, mask, page / 'tb.png', *args)
    got = np.asarray(Image.open(page / 'tb.png')).astype(int)
    if mode == 'optimise':
        img = np.asarray(Image.open(src))
        m = _read_mask(mask)
        m = ~m if n == 10 else m
        ref = np.asarray(jax_optimise(m[None], img[None], n))[0]
        assert (got == ref).all()
        assert (got == golden.optimise_ref(m, img, n)).all()
        return
    _jax_tool(monkeypatch, 'partial-blur', src, mask, page / 'jb.png',
              *args)
    ref = np.asarray(Image.open(page / 'jb.png')).astype(int)
    assert got.shape == ref.shape
    # float blur sums in another order than XLA's convolution
    assert (got == ref).mean() >= 0.999
    assert np.abs(got - ref).max() <= 1


def test_compress_matches_jax_tool(page, monkeypatch):
    """The root tool's fills and Pillow encodes, on the mask read as
    booleans (``_read_mask``): the same JPEG2000 bytes."""
    src, mask = page / 'in.png', page / 'cmask.png'
    _jax_tool(monkeypatch, 'threshold-image', src, mask, '--dpi', 100)
    _port_tool(compress, src, mask, page / 'tc')
    img, m = np.asarray(Image.open(src)), _read_mask(mask)
    fg = np.asarray(jax_optimise(m[None], img[None], 3))[0]
    bg = np.asarray(jax_optimise(~m[None], img[None], 10))[0]
    ref = {'_fg.jp2': jax_encode_fg(fg, [J2K_FG]).data,
           '_bg.jp2': jax_encode_bg(bg, [J2K_BG]).data}
    for layer, data in ref.items():
        assert (page / ('tc' + layer)).read_bytes() == data
        assert len(data) > 100


def test_pdfimagesmrc_matches_jax_tool(book_pdf, monkeypatch, capsys):
    path, _ = book_pdf
    _jax_tool(monkeypatch, 'pdfimagesmrc', path)
    ref = capsys.readouterr().out
    assert pdfimagesmrc.main([path]) == 0
    got = capsys.readouterr().out
    assert got == ref
    assert 'mask' in got and 'bg' in got


@pytest.mark.parametrize('extra', [[], ['--masks-only']])
def test_mrcview_matches_jax_tool(book_pdf, monkeypatch, tmp_path, extra):
    from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
    path, _ = book_pdf
    _jax_tool(monkeypatch, 'mrcview', path, tmp_path / 'j.pdf', *extra)
    assert mrcview.main([path, str(tmp_path / 't.pdf')] + extra) == 0
    got = (tmp_path / 't.pdf').read_bytes()
    assert got == (tmp_path / 'j.pdf').read_bytes()
    assert PdfReader(str(tmp_path / 't.pdf')).page_count() == \
        (2 if extra else 6)        # 2 pages x (bg, fg, mask)


def test_pdf_to_imagestack_matches_jax_cli(book_pdf, tmp_path):
    path, _ = book_pdf
    assert jax_stack([path, str(tmp_path / 'j.zip')]) == 0
    assert port_stack([path, str(tmp_path / 't.zip')]) == 0
    with zipfile.ZipFile(tmp_path / 'j.zip') as j, \
            zipfile.ZipFile(tmp_path / 't.zip') as t:
        assert t.namelist() == j.namelist() and len(t.namelist()) == 2
        for name in j.namelist():
            assert t.read(name) == j.read(name)


def test_pdfrenderer_matches_jax_cli(book_pdf, tmp_path, monkeypatch):
    _, hocr = book_pdf
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    args = ['-T', hocr, '-D', '100', '-o']
    assert jax_render(args + [str(tmp_path / 'j.pdf')]) == 0
    assert port_render(args + [str(tmp_path / 't.pdf')]) == 0
    got = (tmp_path / 't.pdf').read_bytes()
    assert got == (tmp_path / 'j.pdf').read_bytes()
    assert b'TJ' in got or b'/Font' in got
