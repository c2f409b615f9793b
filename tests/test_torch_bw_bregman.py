"""The bitonal recode with the TV mask denoise (the benchmark's
``bw_bregman`` configuration: ``--bw-pdf --denoise-mask bregman``) on the
CPU: a 3-page PNG book with hOCR lines, made by the benchmark's
generator at a fifth of the cell's page size and resolution, one page
RGB, through ``recode()`` with the configuration's flags.

Judged as the benchmark judges a run, it is correct with no mask pixel
differing from the plain reference (``portbench/reference/
denoise_bregman.py`` after ``reference/mrc.py``); each page is one 1-bit
JBIG2 image; two recodes write the same bytes.  The reference's TV
equals the port's ``ops/tv.py`` bit for bit, imports nothing of the
port or of JAX, and the judge tells apart the port with 90 iterations,
with the threshold at 0.5 or with its two contractions rounded twice,
and the reference computed in bfloat16 (the benchmark's control)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from archive_pdf_tools_tpu_torch.mrc import decompose
from archive_pdf_tools_tpu_torch.ops import dwt97, tv
from archive_pdf_tools_tpu_torch.pipeline.recode import recode
from portbench import control, judge
from portbench.reference import denoise_bregman as reference
from portbench.traffic.generator import make_book

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cell's 3300x2550 pages at 400 DPI, cut to a fifth in each
TRAFFIC = dict(pages=3, height=660, width=510, dpi=80, page_set=20261017,
               rgb_pages=[2], noise_sigma=9.0, format='png')
SEED = 2 ** 40 + 24


def _config():
    with open(os.path.join(ROOT, 'portbench', 'configs',
                           'bw_bregman.json')) as fp:
        config = json.load(fp)
    config['recode']['dpi'] = TRAFFIC['dpi']
    return config


def _iterations(n):
    return lambda mask, weight=1.0: tv.denoise_tv_bregman(
        mask.to(torch.float32), weight, max_iter=n) > 0.4


def _threshold(t):
    return lambda mask, weight=1.0: tv.denoise_tv_bregman(
        mask.to(torch.float32), weight) > t


def _fma_twice(c, s, d, read=bool):
    return c * s + d


# each fault: the module, the name replaced and what replaces it
FAULTS = {
    'iterations_90': (decompose, 'denoise_bregman', _iterations(90)),
    'threshold_0.5': (decompose, 'denoise_bregman', _threshold(0.5)),
    'fma_rounded_twice': (tv, '_fma', _fma_twice),
}


@pytest.fixture(scope='module')
def book(tmp_path_factory):
    """The book and its recodes: sound twice, then with each fault."""
    tmp = tmp_path_factory.mktemp('bw_bregman')
    config = _config()
    bk = make_book(TRAFFIC, SEED, str(tmp / 'book'), workers=2)
    mp = pytest.MonkeyPatch()
    mp.setenv('SOURCE_DATE_EPOCH', '1700000000')
    pdfs = {}
    try:
        for name in ('sound', 'again') + tuple(FAULTS):
            with mp.context() as fault:
                if name in FAULTS:
                    fault.setattr(*FAULTS[name])
                pdfs[name] = str(tmp / (name + '.pdf'))
                recode(out_pdf=pdfs[name], from_imagestack=bk.glob,
                       hocr_file=bk.hocr, device='cpu', **config['recode'])
    finally:
        mp.undo()
    batches = judge.book_batches(bk, config)
    assert batches == [[0, 1], [2]]
    return dict(book=bk, config=config, pdfs=pdfs, batches=batches)


def _judged(book, name):
    return judge.judge(book['book'], book['config'], [book['pdfs'][name]],
                       judge.sha256(book['pdfs'][name]), SEED, 'cpu')


def test_sound_book_is_correct(book):
    checks, correct = _judged(book, 'sound')
    assert correct is True
    assert checks == {'differing_books': (0, 0), 'pdf_faults': (0, 0),
                      'text_faults': (0, 0), 'mask_mismatch': (0.0, 0.0)}


def test_every_batch_equals_the_reference(book):
    pdf = judge.BookPdf(book['pdfs']['sound'], book['book'], book['config'])
    for batch in book['batches']:
        ref, = judge.reference_batch(book['book'], book['config'], batch,
                                     'cpu')
        for k, i in enumerate(batch):
            assert (pdf.mask(i) == ref[k]).all(), i


def test_pages_are_one_jbig2_image(book):
    pdf = judge.BookPdf(book['pdfs']['sound'], book['book'], book['config'])
    assert pdf.faults == []
    for i, images in enumerate(pdf.images):
        s, = images
        assert (s.dict['Filter'], s.dict['Width'], s.dict['Height'],
                s.dict.get('BitsPerComponent', 1)) == \
            ('JBIG2Decode', TRAFFIC['width'], TRAFFIC['height'], 1)
        assert 'SMask' not in s.dict


def test_two_recodes_write_the_same_bytes(book):
    with open(book['pdfs']['sound'], 'rb') as a, \
            open(book['pdfs']['again'], 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('case', list(FAULTS) + ['control_bfloat16'])
def test_fault_is_not_correct(book, case):
    if case == 'control_bfloat16':
        checks, correct = judge.verdict(
            control.readings(book['book'], book['config'], SEED,
                             torch.device('cpu')), book['config'])
    else:
        checks, correct = _judged(book, case)
    assert correct is False
    value, limit = checks['mask_mismatch']
    assert value > limit


@pytest.mark.parametrize('shape', [(2, 37, 53), (1, 64, 64), (3, 101, 29)])
def test_reference_equals_the_port(shape):
    g = torch.Generator().manual_seed(shape[1])
    mask = torch.rand(shape, generator=g) < 0.3
    want = tv.denoise_tv_bregman(mask.to(torch.float32))
    got = reference.tv_bregman(mask.to(torch.float32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(reference.denoise(mask), tv.denoise_bregman(mask))


def test_reference_fma_rounds_once():
    """On sums that land on a float32 rounding midpoint in float64, where
    rounding twice is off by an ulp about every other time, the
    reference's fma is the port's."""
    g = torch.Generator().manual_seed(5)
    n = 1 << 16
    m = torch.randint(1, 64, (n,), generator=g).double()
    sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    a = ((1 + m * 2.0 ** -23) * sign).float()
    b = (1 - m * 2.0 ** -23).float()
    c = ((2.0 ** 24 + 2 * torch.randint(0, 1 << 20, (n,), generator=g))
         * sign).float()
    twice = (a.double() * b.double() + c.double()).float()
    once = dwt97._fma(a, b, c)
    assert (twice != once).float().mean() > 0.4
    assert torch.equal(reference.fma32(a, b, c), once)


def test_reference_imports_no_port_and_no_jax():
    code = '\n'.join([
        'import sys',
        'for name in ("jax", "jaxlib", "archive_pdf_tools_tpu",',
        '             "archive_pdf_tools_tpu_torch"):',
        '    sys.modules[name] = None',
        'sys.path.insert(0, %r)' % ROOT,
        'import torch',
        'from portbench.reference import denoise_bregman',
        'm = torch.zeros(1, 9, 7, dtype=torch.bool)',
        'm[0, 3:6, 2:5] = True',
        'print(int(denoise_bregman.denoise(m).sum()))',
        'print(sorted({k.split(".")[0] for k, v in sys.modules.items()',
        '              if v is not None} & {"jax", "jaxlib",',
        '              "archive_pdf_tools_tpu",',
        '              "archive_pdf_tools_tpu_torch"}))'])
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split('\n')[1] == '[]'
