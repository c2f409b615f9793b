"""The PyTorch port's recode() and CLI held against the JAX package's.

SOURCE_DATE_EPOCH pins the emitted timestamps, so on a noise-free book
whose hOCR holds no words the two pipelines must write the same bytes.
"""

import os
import subprocess
import sys

import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.validators import validate_pdfa
from archive_pdf_tools_tpu.inputs import hocr as jax_hocr

from archive_pdf_tools_tpu_torch.inputs import hocr as port_hocr

from tests.fixtures import (HOCR_TEMPLATE, make_book, render_book_page,
                            words_to_hocr_page)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _no_word_book(tmp_path, n_pages=3, mode='L'):
    """Noise-free pages with empty hOCR; page 1 in ``mode``."""
    hocr = []
    for i in range(n_pages):
        img, _ = render_book_page(320, 416, seed=i, noise=0,
                                  rgb=i == 1 and mode == 'RGB')
        im = Image.fromarray(img)
        if i == 1 and mode == '1':
            im = im.convert('1')
        im.save(str(tmp_path / ('page_%04d.png' % i)))
        hocr.append(words_to_hocr_page([], 320, 416, page_no=i, dpi=100))
    hocr_path = tmp_path / 'book.hocr'
    hocr_path.write_text(HOCR_TEMPLATE % '\n'.join(hocr), encoding='utf-8')
    return str(tmp_path / 'page_*.png'), str(hocr_path)


@pytest.mark.parametrize('mode,image_mode', [('L', 2), ('RGB', 2),
                                             ('1', 2), ('L', 3)])
def test_recode_byte_identical_with_jax(tmp_path, monkeypatch, mode,
                                        image_mode):
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    glob_pat, hocr_path = _no_word_book(tmp_path, mode=mode)
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    kw = dict(from_imagestack=glob_pat, hocr_file=hocr_path, dpi=100,
              jbig2=True, image_mode=image_mode)
    res = recode(out_pdf=str(ours), device='cpu', **kw)
    jax_recode(out_pdf=str(ref), **kw)
    assert res['compression_ratio'] > 0
    validate_pdfa(str(ours))
    assert ours.read_bytes() == ref.read_bytes()


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
    {'jbig2_bands': 2},
])
def test_unported_options_raise(tmp_path, kw):
    from archive_pdf_tools_tpu_torch import recode
    args = dict(from_imagestack=str(tmp_path / '*.png'),
                hocr_file=str(tmp_path / 'x.hocr'),
                out_pdf=str(tmp_path / 'o.pdf'), device='cpu')
    args.update(kw)
    with pytest.raises(NotImplementedError):
        recode(**args)


def test_book_with_words_raises(tmp_path):
    from archive_pdf_tools_tpu_torch import recode
    glob_pat, hocr_path, _ = make_book(tmp_path, n_pages=2, w=320, h=416,
                                       dpi=100)
    with pytest.raises(NotImplementedError, match='hOCR line'):
        recode(from_imagestack=glob_pat, hocr_file=hocr_path,
               out_pdf=str(tmp_path / 'o.pdf'), dpi=100, device='cpu')


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
