"""The ``encode_offload_pct`` reader on a fabricated store: 0 with every
layer encoded on the pool's threads, 100 with each in a worker process,
only the window's books read, and None with no store or nothing to
read (another coder than Pillow's included)."""

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


def _run(books, pages=2, flags=None):
    run = Run(types.SimpleNamespace(pages=pages), flags or {}, 'cpu')
    run.pdfs = ['book_%d.pdf' % i for i in range(books)]
    return run


def _book(call, t0, offloaded):
    """One book's records: its ``recode`` root on the main thread, a
    ``fg_jp2`` and a ``bg_jp2`` span a page on the pool, and a
    ``jp2_pillow`` record (thread ``encode-proc-<pid>``) inside each
    layer span that ``offloaded`` marks True."""
    R = spans.Record
    recs = [R(100 * call, 'recode', None, 'MainThread', 1, call,
              t0 * MS, (t0 + 1000) * MS, 600 * MS)]
    for i, off in enumerate(offloaded):
        name = ('fg_jp2', 'bg_jp2')[i % 2]
        start = t0 + 100 * i
        recs.append(R(100 * call + 1 + 2 * i, name, None, 'encode_%d' % i,
                      2 + i, call, start * MS, (start + 90) * MS, 5 * MS))
        if off:
            recs.append(R(100 * call + 2 + 2 * i, 'jp2_pillow', None,
                          'encode-proc-%d' % (40 + i), 40 + i, call,
                          (start + 2) * MS, (start + 88) * MS, 80 * MS))
    return recs


def _read(monkeypatch, recs, run):
    monkeypatch.setattr(spans, 'collected', lambda: list(recs))
    return Benchmark(ROOT).reader('encode_offload_pct').read(run)


@pytest.mark.parametrize('offloaded,want', [
    ([False] * 4, 0.0), ([True] * 4, 100.0),
    ([True, False, False, True], 50.0)])
def test_encode_offload_pct(monkeypatch, offloaded, want):
    """The share of the window's layer spans with a worker's record; an
    earlier call's layers, none offloaded, are not read."""
    recs = _book(1, 0, [False] * 4) + _book(2, 5000, offloaded)
    assert _read(monkeypatch, recs, _run(1)) == want


def test_encode_offload_pct_two_books(monkeypatch):
    recs = _book(1, 0, [False] * 4) + _book(2, 5000, [True] * 4)
    assert _read(monkeypatch, recs, _run(2)) == 50.0


@pytest.mark.parametrize('recs', ['no_store', 'empty', 'no_layer',
                                  'no_root', 'tpu'])
def test_encode_offload_pct_none(monkeypatch, recs):
    """None with no store, an empty one, no layer span, no recode span,
    or under ``-J tpu``."""
    book = _book(1, 0, [True] * 2)
    if recs == 'tpu':
        run = _run(1, flags={'jpeg2000_implementation': 'tpu'})
        assert _read(monkeypatch, book, run) is None
        return
    if recs == 'no_store':
        monkeypatch.setattr(bench_spans, 'store', lambda: None)
        recs = book
    elif recs == 'empty':
        recs = []
    elif recs == 'no_layer':
        recs = [r for r in book if r.name == 'recode']
    else:
        recs = [r for r in book if r.name != 'recode']
    assert _read(monkeypatch, recs, _run(1)) is None


def test_encode_offload_pct_entry():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fp:
        spec = json.load(fp)
    entry, = [m for m in spec['per_layer']
              if m['name'] == 'encode_offload_pct']
    assert entry == {
        'name': 'encode_offload_pct', 'unit': '%', 'better': 'higher',
        'source': 'program_span', 'moves': 'pages_per_s',
        'layer': 'host encoders (codecs/, native/)',
        'workloads': ['pillow_ds3.jp2book']}
    assert os.path.exists(os.path.join(ROOT, 'portbench', 'metrics',
                                       'encode_offload_pct.py'))
