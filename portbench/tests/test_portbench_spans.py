"""The span readers (``metrics/decode_wait_ms.py``, ``encode_wait_ms``,
``encode_cpu_ms``, ``pdf_write_ms``, ``main_stall_ms``) on a fabricated
store: their values, None on an empty store or one without a ``recode``
span, and only the window's books read."""

import json
import os
import types

import pytest

from conftest import ROOT
from portbench.registry import Benchmark
from portbench.run import Run

from archive_pdf_tools_tpu_torch.utils import spans

NAMES = ('decode_wait_ms', 'encode_wait_ms', 'encode_cpu_ms', 'pdf_write_ms',
         'main_stall_ms')
MS = 1000000   # ns


def _run(books, pages=2):
    run = Run(types.SimpleNamespace(pages=pages), {}, 'cpu')
    run.pdfs = ['book_%d.pdf' % i for i in range(books)]
    return run


class _Store:
    """Records of one book a call, as recode() leaves them: ``wall`` and
    ``cpu`` in ms for each (name, thread, parent) below."""

    def __init__(self):
        self.recs = []
        self.ids = iter(range(1, 10000))

    def add(self, name, call, thread, parent, start, wall, cpu):
        rec = spans.Record(next(self.ids), name, parent,
                           'MainThread' if thread == 1 else 'encode_0',
                           thread, call, start * MS, (start + wall) * MS,
                           cpu * MS)
        self.recs.append(rec)
        return rec

    def book(self, call, t0):
        root = self.add('recode', call, 1, None, t0, 1000, 600)
        kids = [('text_pages', 10, 10), ('hocr_jobs', 5, 5),
                ('batch_wait', 200, 1), ('process_batch', 300, 100),
                ('batch_wait', 50, 1), ('encode_wait', 100, 2),
                ('page_image_insertion', 4, 4), ('pdf_write', 30, 20)]
        t = t0
        for name, wall, cpu in kids:
            rec = self.add(name, call, 1, root.id, t, wall, cpu)
            if name == 'process_batch':
                # a nested stage and a mask encode on the main thread:
                # neither is a direct child of the root
                self.add('threshold', call, 1, rec.id, t, 20, 20)
                self.add('mask_jbig2', call, 1, rec.id, t + 20, 10, 5)
            t += wall
        for name, wall, cpu in (('mask_jbig2', 40, 30), ('fg_jp2', 90, 60),
                                ('bg_jp2', 70, 50), ('image_load', 80, 80)):
            self.add(name, call, 2, None, t0, wall, cpu)


@pytest.fixture
def readers():
    bench = Benchmark(ROOT)
    return {n: bench.reader(n) for n in NAMES}


def _read(readers, monkeypatch, recs, run):
    monkeypatch.setattr(spans, 'collected', lambda: list(recs))
    return {n: r.read(run) for n, r in readers.items()}


def test_values(readers, monkeypatch):
    st = _Store()
    st.book(call=1, t0=0)
    got = _read(readers, monkeypatch, st.recs, _run(1))
    # ms a page, 2 pages
    assert got['decode_wait_ms'] == pytest.approx((200 + 50) / 2)
    assert got['encode_wait_ms'] == pytest.approx(100 / 2)
    assert got['encode_cpu_ms'] == pytest.approx((5 + 30 + 60 + 50) / 2)
    assert got['pdf_write_ms'] == pytest.approx((10 + 4 + 30) / 2)
    # wall - cpu of text_pages, hocr_jobs, process_batch,
    # page_image_insertion and pdf_write; not of the two waits
    assert got['main_stall_ms'] == pytest.approx((0 + 0 + 200 + 0 + 10) / 2)


def test_only_the_window_books(readers, monkeypatch):
    """A store that still holds an earlier call: the last len(run.pdfs)
    roots are the window's."""
    st = _Store()
    st.book(call=7, t0=0)
    st.book(call=8, t0=5000)
    st.recs.append(st.recs.pop(0))   # stored order is not start order
    one = _read(readers, monkeypatch, st.recs, _run(1))
    st2 = _Store()
    st2.book(call=8, t0=5000)
    assert one == _read(readers, monkeypatch, st2.recs, _run(1))
    two = _read(readers, monkeypatch, st.recs, _run(2, pages=2))
    assert two['decode_wait_ms'] == pytest.approx(2 * (250 / 2) / 2)


def test_main_stall_leaves_out_the_waits(readers, monkeypatch):
    st = _Store()
    st.book(call=1, t0=0)
    base = _read(readers, monkeypatch, st.recs, _run(1))['main_stall_ms']
    slow = [r._replace(end_ns=r.end_ns + 500 * MS)
            if r.name in ('batch_wait', 'encode_wait') else r
            for r in st.recs]
    assert _read(readers, monkeypatch, slow,
                 _run(1))['main_stall_ms'] == base


@pytest.mark.parametrize('recs', [[], 'no_root'])
def test_none_without_a_recode_span(readers, monkeypatch, recs):
    if recs == 'no_root':
        st = _Store()
        st.book(call=1, t0=0)
        recs = [r for r in st.recs if r.name != 'recode']
    got = _read(readers, monkeypatch, recs, _run(1))
    assert got == {n: None for n in NAMES}


def test_none_without_the_store(readers, monkeypatch):
    """A program with no span store (the parent of the span readers):
    None, and no exception."""
    import builtins
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == 'archive_pdf_tools_tpu_torch.utils' and fromlist \
                and 'spans' in fromlist:
            raise ImportError('no spans')
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, '__import__', no_spans)
    assert {n: r.read(_run(1)) for n, r in readers.items()} == \
        {n: None for n in NAMES}


def test_entries_name_existing_readers():
    """Each reader's entry is there once, wherever it stands in the list,
    and reads in every cell."""
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fp:
        spec = json.load(fp)
    names = [m['name'] for m in spec['per_layer']]
    entries = {m['name']: m for m in spec['per_layer']}
    for name in NAMES:
        assert names.count(name) == 1
        entry = entries[name]
        assert entry['source'] == 'program_span'
        assert entry['moves'] == 'pages_per_s'
        assert entry['unit'] == 'ms/page' and entry['better'] == 'lower'
        assert 'workloads' not in entry
        assert os.path.exists(os.path.join(ROOT, 'portbench', 'metrics',
                                           name + '.py'))
