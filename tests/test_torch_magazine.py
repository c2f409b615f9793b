"""The colour-magazine recode (the benchmark's ``jtpu_magazine``
configuration) on the CPU: a 3-page all-RGB JPEG2000 magazine with hOCR
lines, made by the benchmark's generator at a fifth of the cell's page
size and resolution, through ``recode()`` with the configuration's flags.

Its masks equal the plain reference's (``portbench/reference/mrc.py``)
exactly; its fg and bg layers, decoded, are within the configuration's
``layer_limits`` of the reference's layers; the same recode with the
coder's chroma components swapped, or zeroed, is not; and two recodes
write the same bytes."""

import json
import os

import pytest
import torch

from archive_pdf_tools_tpu_torch.codecs import jp2tpu
from archive_pdf_tools_tpu_torch.pipeline.recode import recode
from portbench import judge
from portbench.traffic.generator import make_book

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cell's 3300x2550 pages at 400 DPI, cut to a fifth in each
TRAFFIC = dict(pages=3, height=660, width=510, dpi=80, page_set=20261017,
         rgb_pages=[0, 1, 2], noise_sigma=9.0, format='jp2', jp2_rate=10)


def _config():
    with open(os.path.join(ROOT, 'portbench', 'configs',
                           'jtpu_magazine.json')) as fp:
        config = json.load(fp)
    config['recode']['dpi'] = TRAFFIC['dpi']
    return config


def _chroma(fault):
    """``dwt97`` with the Cb and Cr components of an RGB layer swapped or
    zeroed after the colour transform."""
    real = jp2tpu.dwt97

    def dwt97(imgs, levels, base_delta):
        comps = real(imgs, levels, base_delta)
        if len(comps) != 3:
            return comps
        y, cb, cr = comps
        if fault == 'swap':
            return (y, cr, cb)
        return (y,) + tuple(tuple(torch.zeros_like(b) for b in c)
                            for c in (cb, cr))
    return dwt97


@pytest.fixture(scope='module')
def magazine(tmp_path_factory):
    """The magazine, its recodes (sound twice, then each chroma fault) and
    the reference's masks and layers of its one batch."""
    tmp = tmp_path_factory.mktemp('magazine')
    config = _config()
    book = make_book(TRAFFIC, 2 ** 40 + 19, str(tmp / 'book'), workers=2)
    mp = pytest.MonkeyPatch()
    mp.setenv('SOURCE_DATE_EPOCH', '1700000000')
    pdfs = {}
    try:
        for name in ('sound', 'again', 'swap', 'zero'):
            if name in ('swap', 'zero'):
                mp.setattr(jp2tpu, 'dwt97', _chroma(name))
            pdfs[name] = str(tmp / (name + '.pdf'))
            recode(out_pdf=pdfs[name], from_imagestack=book.glob,
                   hocr_file=book.hocr, device='cpu', **config['recode'])
    finally:
        mp.undo()
    batch = list(range(book.pages))
    assert judge.book_batches(book, config) == [batch]
    ref = judge.reference_batch(book, config, batch, 'cpu')
    return dict(book=book, config=config, pdfs=pdfs, batch=batch, ref=ref)


def _errors(magazine, name):
    """{fg_err, bg_err}: the largest mean absolute difference over the
    magazine's pages between a recode's decoded layer and the reference's."""
    pdf = judge.BookPdf(magazine['pdfs'][name], magazine['book'], magazine['config'])
    assert pdf.faults == []
    out = {}
    for i in magazine['batch']:
        for key, layer in (('fg_err', 1), ('bg_err', 2)):
            got = judge.decode_jpx(pdf.images[i][layer].raw)
            assert got.ndim == 3 and got.shape[2] == 3
            err = judge.mean_abs(got, magazine['ref'][layer][i])
            out[key] = max(out.get(key, 0.0), err)
    return out, pdf


def test_masks_equal_the_reference(magazine):
    _, pdf = _errors(magazine, 'sound')
    for i in magazine['batch']:
        assert (pdf.mask(i) == magazine['ref'][0][i]).all()


def test_layers_within_the_limits(magazine):
    errs, _ = _errors(magazine, 'sound')
    limits = magazine['config']['layer_limits']
    assert set(errs) == set(limits)
    for key, lim in limits.items():
        assert errs[key] <= lim, (key, errs[key], lim)


@pytest.mark.parametrize('fault', ['swap', 'zero'])
def test_chroma_faults_exceed_the_limits(magazine, fault):
    errs, _ = _errors(magazine, fault)
    limits = magazine['config']['layer_limits']
    assert any(errs[key] > lim for key, lim in limits.items()), errs


def test_two_recodes_write_the_same_bytes(magazine):
    with open(magazine['pdfs']['sound'], 'rb') as a, \
            open(magazine['pdfs']['again'], 'rb') as b:
        assert a.read() == b.read()
