"""The judge, the reference, the roofline and the generator follow what a
configuration and a traffic file say: ``--bw-pdf`` pages judged as
mask-only pages, the reference's denoise found by its mode's file name,
books with no hOCR words, flags the judge does not model refused; and
the existing traffic and roofline work pinned to what they were before
these flags were read."""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from conftest import (ROOT, TINY_TRAFFIC, TTPU_TRAFFIC, add_cell,
                      copy_benchmark)
from portbench import control, faults, judge, roofline, roofline_dwt
from portbench.registry import Benchmark
from portbench.run import run_cell
from portbench.traffic import generator

BW = {'force_1bit_output': True}


@pytest.fixture(scope='module')
def flags_root(tmp_path_factory):
    """A copy of the benchmark with tiny cells ``tbwnone.book`` and
    ``tbwfast.book`` (``--bw-pdf`` at ``--denoise-mask`` none and fast)
    and ``tnowords.book`` (``-J tpu``, a book with no hOCR words)."""
    root = copy_benchmark(str(tmp_path_factory.mktemp('flags') / 'ck'))
    for mode in ('none', 'fast'):
        add_cell(root, 'tbw' + mode, 'pillow_ds3', TINY_TRAFFIC,
                 recode=dict(BW, denoise_mask=mode))
    add_cell(root, 'tnowords', 'jtpu', dict(TTPU_TRAFFIC, words=False),
             layer_limits={'fg_err': 20.0, 'bg_err': 18.0})
    return root


def _run(root, workload):
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(workload, 98765432109, 0.0, False, root=root,
                  device='cpu', out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize('mode', ['none', 'fast'])
def test_bw_book_correct(flags_root, mode):
    """Mask-only pages, held to the reference's mask in the mode the
    configuration names: no layer is read."""
    res = _run(flags_root, 'tbw%s.book' % mode)
    assert res['correct'] is True
    assert res['checks'] == {
        'differing_books': {'value': 0, 'limit': 0},
        'pdf_faults': {'value': 0, 'limit': 0},
        'text_faults': {'value': 0, 'limit': 0},
        'mask_mismatch': {'value': 0.0, 'limit': 0.0}}


# each case: the cell, the fault planted (``faults.FAULTS``) and the
# number that has to fail
BROKEN_BW = {
    'inverted': ('fast', 'page_inverted', 'mask_mismatch'),
    'not_despeckled': ('fast', 'despeckle_unchanged', 'mask_mismatch'),
    'mask_altered': ('none', 'mask_altered', 'mask_mismatch'),
    'extra_image': ('none', 'extra_image', 'pdf_faults'),
}


@pytest.mark.parametrize('case', list(BROKEN_BW))
def test_bw_broken_is_not_correct(flags_root, case):
    mode, fault, number = BROKEN_BW[case]
    with faults.plant(fault):
        res = _run(flags_root, 'tbw%s.book' % mode)
    assert res['correct'] is False
    got = res['checks'][number]
    assert got['value'] > got['limit']


def test_nowords_book_correct(flags_root):
    res = _run(flags_root, 'tnowords.book')
    assert res['correct'] is True
    assert res['checks']['text_faults']['value'] == 0
    assert {'fg_err', 'bg_err'} <= set(res['checks'])


def test_nowords_hocr_has_no_lines(tmp_path):
    """``words: false``: every page in the hOCR, no line, no box, the
    pixels of the worded book."""
    spec = dict(TINY_TRAFFIC, words=False)
    book = generator.make_book(spec, 5, str(tmp_path / 'a'), workers=2)
    worded = generator.make_book(TINY_TRAFFIC, 5, str(tmp_path / 'b'),
                                 workers=2)
    with open(book.hocr) as fp:
        hocr = fp.read()
    assert hocr.count('class="ocr_page"') == spec['pages']
    assert 'ocr_line' not in hocr.split('</head>')[1]
    assert 'ocrx_word' not in hocr.split('</head>')[1]
    assert book.boxes == [[]] * spec['pages'] and any(worded.boxes)
    assert _pixels(book) == _pixels(worded)
    assert generator.spec_key(spec) != generator.spec_key(TINY_TRAFFIC)


def test_words_must_be_a_bool(tmp_path):
    path = tmp_path / 't.json'
    path.write_text(json.dumps(dict(TINY_TRAFFIC, words='no')))
    with pytest.raises(ValueError, match='words'):
        generator.load(str(path))


@pytest.mark.parametrize('mode', ['none', 'fast'])
def test_bw_control_is_not_correct(flags_root, mode):
    """The bf16 control of a ``--bw-pdf`` configuration is judged by its
    mask alone, and fails it on three seeds."""
    import torch
    bench = Benchmark(flags_root)
    config = bench.config('tbw' + mode)
    spec = dict(bench.traffic('tbw' + mode), height=416, width=320)
    for seed in (11, 12, 13):
        book = generator.make_book(
            spec, seed, os.path.join(flags_root, 'c%s%d' % (mode, seed)),
            workers=2)
        checks, correct = judge.verdict(
            control.readings(book, config, seed, torch.device('cpu')), config)
        assert correct is False
        assert set(checks) == {'mask_mismatch'}
        assert checks['mask_mismatch'][0] > checks['mask_mismatch'][1]


def _config(**recode):
    with open(os.path.join(ROOT, 'portbench', 'configs', 'jtpu.json')) as fp:
        c = json.load(fp)
    c['recode'].update(recode)
    return c


def test_mode_without_a_reference_raises():
    """A denoise mode with no ``reference/denoise_<mode>.py``: judge()
    and the control raise, naming the mode and the file, before reading
    anything."""
    config = _config(denoise_mask='bregman')
    for call in (lambda: judge.judge(None, config, [], None, 1, 'cpu'),
                 lambda: control.readings(None, config, 1, 'cpu')):
        with pytest.raises(ValueError,
                           match="'bregman'.*reference/denoise_bregman.py"):
            call()


@pytest.mark.parametrize('flag,value', [
    ('grayscale_pdf', True), ('mask_compression', 'ccitt'),
    ('jbig2_symbol_mode', 'auto'), ('image_mode', 1), ('downsample', 2),
    ('jbig2', False), ('hq_pages', [True]), ('some_new_flag', 1)])
def test_unmodelled_flag_raises(flag, value):
    with pytest.raises(ValueError, match=flag):
        judge.judge(None, _config(**{flag: value}), [], None, 1, 'cpu')


def test_cells_are_modelled():
    bench = Benchmark(ROOT)
    for c in bench.spec['configs']:
        judge.check_config(bench.config(c['name']))
    for flags in (BW, dict(BW, denoise_mask='none'),
                  dict(denoise_mask=None)):
        judge.check_config(_config(**flags))


# page_work on the cells' page shapes and the boxes of the pngbook's
# variant 0 (51 lines), and with no boxes, as before the flags were read
PAGE_WORK = {
    ('jtpu', (3300, 2550), 51): (37517700, 1219704952.0),
    ('jtpu', (3300, 2550), 0): (37517700, 1089275000.0),
    ('jtpu', (3300, 2550, 3), 51): (110447700, 2396869952.0),
    ('jtpu', (3300, 2550, 3), 0): (110447700, 2266440000.0),
    ('pillow_ds3', (3300, 2550), 51): (18817700, 985954952),
    ('pillow_ds3', (3300, 2550), 0): (18817700, 855525000),
    ('pillow_ds3', (3300, 2550, 3), 51): (54347700, 1611469952),
    ('pillow_ds3', (3300, 2550, 3), 0): (54347700, 1481040000),
    ('jtpu_magazine', (3300, 2550), 51): (37517700, 1219704952.0),
    ('jtpu_magazine', (3300, 2550), 0): (37517700, 1089275000.0),
    ('jtpu_magazine', (3300, 2550, 3), 51): (110447700, 2396869952.0),
    ('jtpu_magazine', (3300, 2550, 3), 0): (110447700, 2266440000.0),
}
DWT_WORK = {(3300, 2550): (46750000, 233750000.0),
            (3300, 2550, 3): (140250000, 785400000.0)}


@pytest.fixture(scope='module')
def cell_boxes():
    spec = generator.load(os.path.join(ROOT, 'portbench', 'traffic',
                                       'pngbook.json'))
    _, boxes = generator.make_variant(spec, 0)
    assert len(boxes) == 51
    return boxes


def test_page_work_pinned(cell_boxes):
    bench = Benchmark(ROOT)
    for (name, shape, n), want in PAGE_WORK.items():
        flags = bench.config(name)['recode']
        got = roofline.page_work(shape, cell_boxes[:n], 9.0, flags)
        assert got == want and type(got[1]) is type(want[1]), (name, shape)
        if flags['jpeg2000_implementation'] == 'tpu':
            assert roofline_dwt.page_work(shape, flags) == DWT_WORK[shape]


def test_page_work_follows_the_flags(cell_boxes):
    """``--bw-pdf``: the mask's work alone; the despeckle only in mode
    fast."""
    jtpu = Benchmark(ROOT).config('jtpu')['recode']
    o = roofline.OPS
    for shape in ((3300, 2550), (3300, 2550, 3)):
        h, w = shape[:2]
        c = shape[2] if len(shape) == 3 else 1
        nb, ops = roofline.page_work(shape, cell_boxes, 9.0, jtpu)
        bw_nb, bw_ops = roofline.page_work(shape, cell_boxes, 9.0,
                                           dict(jtpu, **BW))
        assert bw_nb == h * w * c + h * -(-w // 8)
        assert roofline_dwt.page_work(shape, dict(jtpu, **BW)) == (0, 0)
        none = roofline.page_work(shape, cell_boxes, 9.0,
                                  dict(jtpu, force_1bit_output=True,
                                       denoise_mask='none'))
        assert none == (bw_nb, bw_ops - h * w * o['despeckle'])
        assert bw_ops < ops - h * w * 2 * o['fill'] * c
        assert roofline.page_work(
            shape, cell_boxes, 9.0, dict(jtpu, denoise_mask='none')) == \
            (nb, ops - h * w * o['despeckle'])


# the traffic as it was before the ``words`` key: the cache keys of the
# cells' traffic files, and a tiny book's pixels, boxes and hOCR
SPEC_KEYS = {'pngbook': '920e96b1c09b44a1', 'jp2book': 'f86a29facaadec47',
             'magazine': '0e74e6c5fb2f2f09'}
TINY_BOOK = {
    'pixels': 'd0af1a810cce64cbb99517b9261f56ee'
              '9d0f98aa1756ca341d36ebd042f7f6ce',
    'boxes': 'b53ed57001c5c98bf3747066e0e27d43'
             'ec4d80305af0c7127184031441048b34',
    'hocr': 'fc9f6e12e2aa5852221cdee2d71b1485'
            '8135b698e94ad89822123eb0753f78c9',
}


def _pixels(book):
    h = hashlib.sha256()
    for f in book.files:
        with Image.open(f) as im:
            h.update(np.asarray(im).tobytes())
    return h.hexdigest()


def test_existing_traffic_unchanged(tmp_path):
    for name, key in SPEC_KEYS.items():
        spec = generator.load(os.path.join(ROOT, 'portbench', 'traffic',
                                           name + '.json'))
        assert 'words' not in spec
        assert generator.spec_key(spec) == key
    book = generator.make_book(TINY_TRAFFIC, 5, str(tmp_path / 'b'),
                               workers=2)
    with open(book.hocr, 'rb') as fp:
        hocr = fp.read()
    assert {'pixels': _pixels(book),
            'boxes': hashlib.sha256(
                json.dumps(book.boxes).encode()).hexdigest(),
            'hocr': hashlib.sha256(hocr).hexdigest()} == TINY_BOOK

