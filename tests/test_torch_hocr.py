"""The port's hOCR and scandata readers (copies of the JAX package's over
``utils/etree_compat.py``) held to the JAX package's (over lxml) on
hOCR that is not well-formed: the rows of ROADMAP C16 and 200 seeded
mutated documents (``tests/hocr_cases.py``) read page for page alike,
page order included; a recode of a book whose hOCR has four of the C16
faults writes the JAX recode's bytes and text layer; compress-pdf-images
gives the JAX tool's masks on it and pdfrenderer_torch exits 0 where
bin/pdfrenderer does, with the JAX renderer's words; the reader keeps
O(page) memory, well-formed or recovering.

``python tests/test_torch_hocr.py`` rewrites the pins of
``tests/hocr_cases.py`` (what the JAX reader reads), which
``chip_smoke.py`` phase 3g holds the port's reader to on a machine
without lxml; ``test_pins_are_current`` checks them.
"""

import io
import os
import pprint
import re
import subprocess
import sys
import tracemalloc

import pytest
import torch
from lxml import etree as lxml_etree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'tests'))

import hocr_cases  # noqa: E402
from archive_pdf_tools_tpu.inputs import hocr as jax_hocr  # noqa: E402
from archive_pdf_tools_tpu.inputs import scandata as jax_scandata  # noqa
from archive_pdf_tools_tpu_torch.inputs import hocr as port_hocr  # noqa
from archive_pdf_tools_tpu_torch.inputs import scandata as port_scandata
from archive_pdf_tools_tpu_torch.utils import etree_compat  # noqa: E402

torch.set_num_threads(2)

GROUPS = 20                         # of the mutated documents


def compute_pins():
    """(PINS, PIN_WORDS) as the JAX reader gives them."""
    fx = hocr_cases._fixtures()
    pins, words = {}, {}
    docs = dict(hocr_cases.CASES)
    docs['book'] = hocr_cases.book_hocr(_book_words(fx))
    for seed in range(hocr_cases.N_MUTATED):
        docs['mutated_%03d' % seed] = hocr_cases.mutated(seed)
    for name, data in docs.items():
        pages = hocr_cases.read(jax_hocr, data)
        pins[name] = hocr_cases.digest(pages)
        if not name.startswith('mutated_'):
            words[name] = hocr_cases.words(pages)
    return pins, words


def _book_words(fx, n=3):
    """The words of chip_smoke.py phase 3b's book pages."""
    return [fx.render_book_page(320, 416, seed=i, rgb=i == 1, noise=0)[1]
            for i in range(n)]


def write_pins():
    pins, words = compute_pins()
    path = os.path.join(ROOT, 'tests', 'hocr_cases.py')
    with open(path, encoding='utf-8') as fp:
        text = fp.read()
    begin = text.index('PINS = ')
    end = text.index('# -- end of the pins')
    body = 'PINS = %s\nPIN_WORDS = %s\n' % (
        pprint.pformat(pins, width=76),
        pprint.pformat(words, width=76, compact=True))
    with open(path, 'w', encoding='utf-8') as fp:
        fp.write(text[:begin] + body + text[end:])


def _both(data):
    return (hocr_cases.read(port_hocr, data),
            hocr_cases.read(jax_hocr, data))


@pytest.mark.parametrize('name', sorted(hocr_cases.CASES))
def test_c16_rows_read_as_the_jax_reader(name):
    """Page for page (dimensions, scan resolution, word data), in the
    JAX reader's page order, and as pinned."""
    ours, ref = _both(hocr_cases.CASES[name])
    assert ours == ref
    assert hocr_cases.digest(ours) == hocr_cases.PINS[name]
    assert hocr_cases.words(ours) == hocr_cases.PIN_WORDS[name]


def test_c16_rows_give_the_table_of_roadmap_c16():
    """The JAX package's reads that the port now gives, row by row."""
    words = {name: hocr_cases.words(hocr_cases.read(port_hocr, data))
             for name, data in hocr_cases.CASES.items()}
    assert words['nbsp_doctype'] == [['Hithere', 'next']]
    assert words['nbsp_no_doctype'] == [['Hithere', 'next']]
    assert words['bare_amp'] == [['A', 'next']]
    assert words['meta_unclosed'] == [['page']]
    assert words['cut_20'] == [['one', 'two'], ['three']]
    assert words['cut_60'] == [['one', 'two'], []]
    assert words['bad_byte'] == [['o�k', 'café', 'über']]
    # the pages in swapped order; the first page emptied by the
    # iterator's clearing of the live tree
    assert words['lt_in_word'] == [['p1'], ['a', 'c']]
    assert words['unclosed_i'] == [['p1'], []]


@pytest.mark.parametrize('group', range(GROUPS))
def test_mutated_hocr_reads_as_the_jax_reader(group):
    per = hocr_cases.N_MUTATED // GROUPS
    for seed in range(group * per, (group + 1) * per):
        data = hocr_cases.mutated(seed)
        ours, ref = _both(data)
        assert ours == ref, (seed, data)
        assert hocr_cases.digest(ours) == \
            hocr_cases.PINS['mutated_%03d' % seed]


def test_pins_are_current():
    """tests/hocr_cases.py's pins are what the JAX reader reads today
    (``python tests/test_torch_hocr.py`` rewrites them)."""
    pins, words = compute_pins()
    assert pins == hocr_cases.PINS
    assert words == hocr_cases.PIN_WORDS


def _text_layer_words(pdf):
    """The words of a PDF's text layer, read back with the port's text
    extraction and hOCR reader."""
    from archive_pdf_tools_tpu_torch.pdf.textextract import pdf_to_hocr
    buf = io.BytesIO()
    pdf_to_hocr(str(pdf), buf)
    return hocr_cases.words(hocr_cases.read(port_hocr, buf.getvalue()))


def test_recode_of_the_c16_book_matches_jax(tmp_path, monkeypatch):
    """recode() of chip_smoke.py's small book with four C16 faults in its
    hOCR, on the CPU: the JAX recode's bytes (so its mask and text
    layer), and the pinned words in the text layer."""
    from PIL import Image
    from archive_pdf_tools_tpu.const import PRODUCER as JAX_PRODUCER
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    from archive_pdf_tools_tpu_torch import recode
    from archive_pdf_tools_tpu_torch.pdf import builder as port_builder
    from archive_pdf_tools_tpu_torch.validators import validate_pdfa
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    fx = hocr_cases._fixtures()
    for i in range(3):
        img, _ = fx.render_book_page(320, 416, seed=i, rgb=i == 1, noise=0)
        Image.fromarray(img).save(str(tmp_path / ('page_%04d.png' % i)))
    hocr = tmp_path / 'book.hocr'
    hocr.write_bytes(hocr_cases.book_hocr(_book_words(fx)))
    kw = dict(from_imagestack=str(tmp_path / 'page_*.png'),
              hocr_file=str(hocr), dpi=100, jbig2=True)
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    recode(out_pdf=str(ours), device='cpu', **kw)
    jax_recode(out_pdf=str(ref), **kw)
    validate_pdfa(str(ours))
    assert ours.read_bytes() == ref.read_bytes()
    assert _text_layer_words(ours) == hocr_cases.PIN_WORDS['book']


def test_compress_pdf_images_on_c16_hocr_matches_jax(tmp_path):
    """compress-pdf-images with the faulty hOCR of a two-page noise-free
    source: the JAX tool's masks, bit for bit."""
    from archive_pdf_tools_tpu.cli.compress_pdf_images import \
        main as jax_comp
    from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import \
        main as comp_main
    from tests.test_torch_cli_tools import _held_to_jax, _jpeg_source
    src, _ = _jpeg_source(tmp_path, noise=False)
    hocr = tmp_path / 'c16.hocr'
    hocr.write_bytes(hocr_cases.book_hocr(
        _book_words(hocr_cases._fixtures(), 2)))
    ours, ref = str(tmp_path / 'torch.pdf'), str(tmp_path / 'jax.pdf')
    assert comp_main([src, str(hocr), ours, '--dpi', '100',
                      '--device', 'cpu']) == 0
    assert jax_comp([src, str(hocr), ref, '--dpi', '100']) == 0
    _held_to_jax(ours, ref, exact=True)


@pytest.mark.parametrize('name', ['nbsp_doctype', 'lt_in_word'])
def test_pdfrenderer_on_c16_file_exits_0_as_jax(tmp_path, name):
    """bin/pdfrenderer_torch on a C16 one-page (and the swapped two-page)
    file exits 0, as bin/pdfrenderer does, with its words."""
    hocr = tmp_path / (name + '.hocr')
    hocr.write_bytes(hocr_cases.CASES[name])
    outs = {}
    for tool in ('pdfrenderer', 'pdfrenderer_torch'):
        outs[tool] = tmp_path / (tool + '.pdf')
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, 'bin', tool), '-T',
             str(hocr), '-o', str(outs[tool])], capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, APT_PLATFORM='cpu', OMP_NUM_THREADS='2'))
        assert r.returncode == 0, (tool, r.stderr[-2000:])
    assert _text_layer_words(outs['pdfrenderer_torch']) == \
        _text_layer_words(outs['pdfrenderer']) == \
        [[w for w in page if w] for page in hocr_cases.PIN_WORDS[name]
         if page]


def _long_hocr(path, n_pages, broken):
    """``n_pages`` pages of 20 words; ``broken`` puts a bare '&' in the
    first page, so the recovering half reads the rest."""
    fx = hocr_cases._fixtures()
    words = hocr_cases._line(['w%d' % k for k in range(5)])
    with open(path, 'w', encoding='utf-8') as fp:
        head, tail = fx.HOCR_TEMPLATE.split('%s')
        fp.write(head)
        for i in range(n_pages):
            page = fx.words_to_hocr_page(
                [(x1, y1 + 20 * k, x2, y2 + 20 * k, t)
                 for k in range(4) for x1, y1, x2, y2, t in words],
                300, 400, page_no=i, dpi=300)
            if broken and i == 0:
                page = page.replace('>w1<', '>w&1<')
            fp.write(page + '\n')
        fp.write(tail)


def _peak(path):
    tracemalloc.start()
    n = 0
    for page in port_hocr.hocr_page_iterator(str(path)):
        n += len(port_hocr.hocr_page_to_word_data(page))
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return n, peak


@pytest.mark.parametrize('broken', [False, True],
                         ids=['well_formed', 'recovering'])
def test_reader_memory_is_o_page(tmp_path, broken):
    """The tracemalloc peak over 2,000 pages is within 1.5x of the peak
    over 200: the reader streams, clearing each page as the JAX one
    does, in expat's half and in the recovering one."""
    small, big = tmp_path / 'small.hocr', tmp_path / 'big.hocr'
    _long_hocr(small, 200, broken)
    _long_hocr(big, 2000, broken)
    n_small, p_small = _peak(small)
    n_big, p_big = _peak(big)
    assert (n_small, n_big) == (200, 2000)
    assert p_big <= 1.5 * p_small, (p_small, p_big)


def test_scandata_copy_raises_as_the_jax_reader(tmp_path):
    """A scandata.xml that is not well-formed: each reader raises its
    etree's XMLSyntaxError (the JAX one lxml's); a good one reads
    alike."""
    good = tmp_path / 'good.xml'
    good.write_text(hocr_cases._fixtures().SCANDATA_TEMPLATE % {
        'dpi': 300, 'pages': '<page leafNum="0"><ppi>300</ppi></page>'})
    assert port_scandata.scandata_xml_get_dpi_per_page(str(good)) == \
        jax_scandata.scandata_xml_get_dpi_per_page(str(good)) == ['300']
    bad = tmp_path / 'bad.xml'
    bad.write_text(good.read_text().replace('</pageData>', ''))
    with pytest.raises(lxml_etree.XMLSyntaxError):
        jax_scandata.Scandata(str(bad))
    with pytest.raises(etree_compat.XMLSyntaxError):
        port_scandata.Scandata(str(bad))


def test_port_reader_names_match_the_jax_reader():
    """The copies export the JAX modules' public names."""
    for ours, ref in ((port_hocr, jax_hocr), (port_scandata, jax_scandata)):
        names = {n for n in vars(ref) if not n.startswith('_') and
                 n not in ('etree', 'io')}
        assert names <= set(vars(ours)), names - set(vars(ours))
    assert port_hocr.WRITING_DIRECTION_TOP_TO_BOTTOM == 3
    pages = list(port_hocr.hocr_from_string(hocr_cases.CASES['bare_amp']))
    assert len(pages) == 1 and re.search('div$', pages[0].tag)


if __name__ == '__main__':
    write_pins()
