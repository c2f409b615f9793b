"""The ``decode_ahead_pct`` reader on a fabricated store: 0 with every
``image_load`` on the ``loader`` thread, 100 with none on it, only the
window's books read, and None with no store or nothing to read."""

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


def _run(books, pages=4):
    run = Run(types.SimpleNamespace(pages=pages), {}, 'cpu')
    run.pdfs = ['book_%d.pdf' % i for i in range(books)]
    return run


def _book(call, t0, threads):
    """One book's records: its ``recode`` root on the main thread and one
    ``image_load`` record a page on each of ``threads``."""
    root = spans.Record(100 * call, 'recode', None, 'MainThread', 1, call,
                        t0 * MS, (t0 + 1000) * MS, 600 * MS)
    loads = [spans.Record(100 * call + 1 + i, 'image_load', None, name,
                          2 + i, call, (t0 + 10 * i) * MS,
                          (t0 + 10 * i + 80) * MS, 80 * MS)
             for i, name in enumerate(threads)]
    return [root] + loads


def _read(monkeypatch, recs, run):
    monkeypatch.setattr(spans, 'collected', lambda: list(recs))
    return Benchmark(ROOT).reader('decode_ahead_pct').read(run)


@pytest.mark.parametrize('threads,want', [
    (['loader'] * 4, 0.0),
    (['decode_0', 'decode_1', 'decode-proc-0', 'decode-proc-3'], 100.0),
    (['loader', 'decode_0', 'decode-proc-1', 'loader'], 50.0)])
def test_decode_ahead_pct(monkeypatch, threads, want):
    """The share of the window's image_load records off the loader; an
    earlier call's records, all on the loader, are not read."""
    recs = _book(1, 0, ['loader'] * 4) + _book(2, 5000, threads)
    assert _read(monkeypatch, recs, _run(1)) == want


def test_decode_ahead_pct_two_books(monkeypatch):
    recs = _book(1, 0, ['loader'] * 4) + _book(2, 5000, ['decode_0'] * 4)
    assert _read(monkeypatch, recs, _run(2)) == 50.0


@pytest.mark.parametrize('recs', ['no_store', 'empty', 'no_image_load',
                                  'no_root'])
def test_decode_ahead_pct_none(monkeypatch, recs):
    """None with no store, an empty one, no image_load record or no
    recode span."""
    book = _book(1, 0, ['decode_0'] * 2)
    if recs == 'no_store':
        monkeypatch.setattr(bench_spans, 'store', lambda: None)
        recs = book
    elif recs == 'empty':
        recs = []
    elif recs == 'no_image_load':
        recs = [r for r in book if r.name != 'image_load']
    else:
        recs = [r for r in book if r.name != 'recode']
    assert _read(monkeypatch, recs, _run(1)) is None


def test_decode_ahead_pct_entry():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fp:
        spec = json.load(fp)
    entries = {m['name']: m for m in spec['per_layer']}
    assert entries['decode_ahead_pct'] == {
        'name': 'decode_ahead_pct', 'unit': '%', 'better': 'higher',
        'source': 'program_span', 'moves': 'pages_per_s',
        'layer': 'page decode (pipeline/recode.py _load_page_image)'}
    assert os.path.exists(os.path.join(ROOT, 'portbench', 'metrics',
                                       'decode_ahead_pct.py'))
