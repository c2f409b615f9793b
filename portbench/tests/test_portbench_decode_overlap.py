"""The ``decode_overlap`` reader on a fabricated store: the decodes'
summed wall over the union of their intervals, whatever thread or
process holds them, only the window's books read, and None with no
store or no ``image_load`` record."""

import json
import os
import types

import pytest

from conftest import ROOT
from portbench import spans as bench_spans
from portbench.registry import Benchmark
from portbench.run import Run

from archive_pdf_tools_tpu_torch.utils import spans

MS = 1000000   # ns


def _run(books, pages=3):
    run = Run(types.SimpleNamespace(pages=pages), {}, 'cpu')
    run.pdfs = ['book_%d.pdf' % i for i in range(books)]
    return run


def _book(call, t0, loads):
    """One book's records: its ``recode`` root on the main thread and an
    ``image_load`` record for each (thread, start, end) in ms after
    ``t0``."""
    root = spans.Record(100 * call, 'recode', None, 'MainThread', 1, call,
                        t0 * MS, (t0 + 1000) * MS, 600 * MS)
    return [root] + [
        spans.Record(100 * call + 1 + i, 'image_load', None, thread, 2 + i,
                     call, (t0 + start) * MS, (t0 + end) * MS,
                     (end - start) * MS)
        for i, (thread, start, end) in enumerate(loads)]


def _read(monkeypatch, recs, run):
    monkeypatch.setattr(spans, 'collected', lambda: list(recs))
    return Benchmark(ROOT).reader('decode_overlap').read(run)


# two decodes overlapping by 50 ms, one apart: 300 ms of decodes over a
# union of 150 + 100 ms
APART = [('decode-proc-7', 0, 100), ('decode-proc-8', 50, 150),
         ('decode_0', 300, 400)]


@pytest.mark.parametrize('loads,want', [
    (APART, 1.2),
    ([('loader', 0, 100), ('loader', 100, 180)], 1.0),
    ([('decode-proc-%d' % i, 0, 100) for i in range(8)], 8.0),
    ([('decode-proc-1', 0, 400), ('decode-proc-2', 100, 200)], 1.25)])
def test_decode_overlap(monkeypatch, loads, want):
    """An earlier call's decodes, all at once, are not read."""
    recs = (_book(1, 0, [('decode-proc-%d' % i, 0, 50) for i in range(4)])
            + _book(2, 5000, loads))
    assert _read(monkeypatch, recs, _run(1)) == pytest.approx(want)


def test_decode_overlap_two_books(monkeypatch):
    """The union runs over the window's books: one at a time in the
    first, two at once in the second."""
    recs = (_book(1, 0, [('loader', 0, 100)])
            + _book(2, 5000, [('decode_0', 0, 100), ('decode_1', 0, 100)]))
    assert _read(monkeypatch, recs, _run(2)) == pytest.approx(1.5)


@pytest.mark.parametrize('recs', ['no_store', 'empty', 'no_image_load'])
def test_decode_overlap_none(monkeypatch, recs):
    """None with no store, an empty one, or no image_load record."""
    book = _book(1, 0, APART)
    if recs == 'no_store':
        monkeypatch.setattr(bench_spans, 'store', lambda: None)
        recs = book
    elif recs == 'empty':
        recs = []
    else:
        recs = [r for r in book if r.name != 'image_load']
    assert _read(monkeypatch, recs, _run(1)) is None


def test_decode_overlap_entry():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fp:
        spec = json.load(fp)
    entries = {m['name']: m for m in spec['per_layer']}
    assert entries['decode_overlap'] == {
        'name': 'decode_overlap', 'unit': 'decodes', 'better': 'higher',
        'source': 'program_span', 'moves': 'pages_per_s',
        'layer': 'page decode (pipeline/recode.py _load_page_image)'}
