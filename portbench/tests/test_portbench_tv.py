"""The TV denoise's metrics (``metrics/tv_ms.py``, ``tv_syncs``,
``tv_roofline_pct``) and its least work (``roofline_tv.py``): the work
pinned on the cells' page shapes, the readers on a tiny traced
``--bw-pdf --denoise-mask bregman`` run, the roofline share on a
fabricated trace and store, and None where the program has no TV
spans."""

import io
import json
import types

import pytest

from conftest import ROOT, TINY_TRAFFIC, add_cell, copy_benchmark
from portbench import control, judge, roofline, roofline_tv
from portbench.registry import Benchmark
from portbench.run import Run, run_cell
from portbench.trace import Trace

from archive_pdf_tools_tpu_torch.utils import spans

NAMES = ('tv_ms', 'tv_syncs', 'tv_roofline_pct')
H100 = 'NVIDIA H100 80GB HBM3'
# the cells' 3300x2550 pages: the mask read and written once, 100
# iterations of 44 bytes and 31 operations a pixel, 2 more a pixel
TV_WORK = (37042830000, 26103330000)


@pytest.fixture(scope='module')
def bench():
    return Benchmark(ROOT)


def test_work_pinned(bench):
    flags = bench.config('bw_bregman')['recode']
    for shape in ((3300, 2550), (3300, 2550, 3)):
        assert roofline_tv.page_work(shape, flags) == TV_WORK
        for name in ('jtpu', 'pillow_ds3', 'jtpu_magazine'):
            assert roofline_tv.page_work(
                shape, bench.config(name)['recode']) == (0, 0)
    assert roofline_tv.book_work([(3300, 2550)] * 16, flags) == \
        (16 * TV_WORK[0], 16 * TV_WORK[1])
    least, bound = roofline.least_seconds(*TV_WORK)
    assert bound == 'bytes' and 0.0110 < least < 0.0111


def test_bregman_has_a_reference(bench):
    """The configuration's mode finds its reference; a mode with no
    ``reference/denoise_<mode>.py`` still raises in judge() and the
    control, naming the mode and the file, before reading anything."""
    config = bench.config('bw_bregman')
    judge.check_config(config)
    config = dict(config, recode=dict(config['recode'], denoise_mask='median'))
    for call in (lambda: judge.judge(None, config, [], None, 1, 'cpu'),
                 lambda: control.readings(None, config, 1, 'cpu')):
        with pytest.raises(ValueError,
                           match="'median'.*reference/denoise_median.py"):
            call()


def test_cell_reports_the_tv_metrics(bench):
    layer = bench.metrics(True, 'bw_bregman.pngbook')
    assert set(NAMES) <= set(layer)
    for name in NAMES:
        assert bench.cells(layer[name][0]) == ['bw_bregman.pngbook']
        assert layer[name][0]['moves'] == 'pages_per_s'


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """A tiny ``--bw-pdf --denoise-mask bregman`` cell run once traced on
    the CPU: 5 pages in batches of 3, 1 and 1 (half the book at most, the
    RGB page 4 alone)."""
    root = copy_benchmark(str(tmp_path_factory.mktemp('tv') / 'ck'))
    cell = add_cell(root, 'tbwb', 'bw_bregman', TINY_TRAFFIC,
                    like='bw_bregman.pngbook')
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, 2 ** 33 + 5, 0.0, True, root=root, device='cpu',
                  out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_readers_on_a_traced_run(traced):
    assert traced['correct'] is True
    m = traced['metrics']
    books = traced['attempted'] // TINY_TRAFFIC['pages']
    # three batches a book, 300 host reads a batch
    assert m['tv_syncs'] == {'value': 300 * 3 * books / traced['attempted'],
                             'unit': 'syncs/page'}
    assert m['tv_ms']['value'] > 0 and m['tv_ms']['unit'] == 'ms/page'
    # the CPU's trace has no kernels
    assert 'tv_roofline_pct' not in m


def _store(books):
    """Records of ``books`` recode calls, each (start, [(tv start, tv
    end)]) in ns on the store's clock, with two ``tv_sync`` spans in each
    ``tv_denoise`` span."""
    recs, ids = [], iter(range(1, 10000))

    def add(name, call, parent, start, end):
        rec = spans.Record(next(ids), name, parent, 'MainThread', 1, call,
                           start, end, end - start)
        recs.append(rec)
        return rec
    for call, (start, tvs) in enumerate(books, 1):
        root = add('recode', call, None, start, start + 10 ** 9)
        for a, b in tvs:
            t = add('tv_denoise', call, root.id, a, b)
            add('tv_sync', call, t.id, a + 10, a + 20)
            add('tv_sync', call, t.id, a + 30, a + 40)
    return recs


def _run(monkeypatch, records, events, pages=2):
    monkeypatch.setattr('portbench.spans.store', lambda: records)
    book = types.SimpleNamespace(pages=pages, shapes=[(100, 80)] * pages)
    run = Run(book, {'force_1bit_output': True, 'denoise_mask': 'bregman'},
              H100)
    run.pdfs = ['book_%d.pdf' % i for i in range(
        sum(r.name == 'recode' for r in records))]
    run.trace = Trace(events)
    return run


def _event(name, cat, ts, dur):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'tid': 1}


@pytest.fixture
def readers(bench):
    return {n: bench.reader(n) for n in NAMES}


def test_readers_on_a_fabricated_window(monkeypatch, readers):
    """Two books; each book's trace span opens 5 us before its ``recode``
    span on the store's clock (shifted by 7 s against the trace's).  The
    kernels inside the TV spans count, clipped to them; those outside do
    not."""
    us = 1000   # ns
    store = _store([(7000 * 10 ** 6, [(7000 * 10 ** 6 + 100 * us,
                                       7000 * 10 ** 6 + 300 * us)]),
                    (7002 * 10 ** 6, [(7002 * 10 ** 6 + 50 * us,
                                       7002 * 10 ** 6 + 90 * us),
                                      (7002 * 10 ** 6 + 200 * us,
                                       7002 * 10 ** 6 + 260 * us)])])
    events = [_event('book 0', 'user_annotation', -5, 1500),
              _event('book 1', 'user_annotation', 1995, 1500),
              # book 0's TV span: 95-295 us on the trace's clock
              _event('k', 'kernel', 80, 20),      # 5 us inside
              _event('k', 'kernel', 120, 100),    # inside
              _event('k', 'kernel', 290, 30),     # 5 us inside
              _event('k', 'kernel', 400, 50),     # outside
              # book 1's: 2045-2085 and 2195-2255 us
              _event('k', 'kernel', 2050, 10),    # inside
              _event('k', 'kernel', 2100, 50),    # between them
              _event('k', 'kernel', 2250, 10)]    # 5 us inside
    run = _run(monkeypatch, store, events)
    spent = (5 + 100 + 5 + 10 + 5) / 1e6
    nbytes, ops = roofline_tv.book_work(run.book.shapes, run.recode_flags)
    least, _ = roofline.least_seconds(2 * nbytes, 2 * ops)
    got = readers['tv_roofline_pct'].read(run)
    assert got == pytest.approx(100.0 * least / spent)
    assert readers['tv_ms'].read(run) == pytest.approx(
        (200 + 40 + 60) / 1e3 / 4)
    assert readers['tv_syncs'].read(run) == 6 / 4


def test_readers_without_tv_spans(monkeypatch, readers):
    """A program without the TV's spans, or a window without the TV:
    every reader reads None."""
    store = [r for r in _store([(0, [(10, 20)])])
             if r.name == 'recode']
    run = _run(monkeypatch, store,
               [_event('book 0', 'user_annotation', 0, 1000),
                _event('k', 'kernel', 10, 10)], pages=1)
    assert {n: readers[n].read(run) for n in NAMES} == dict.fromkeys(NAMES)


def test_roofline_needs_paired_books(monkeypatch, readers):
    store = _store([(0, [(10, 20)])])
    run = _run(monkeypatch, store,
               [_event('book 0', 'user_annotation', 0, 1000),
                _event('book 1', 'user_annotation', 2000, 1000),
                _event('k', 'kernel', 10, 10)], pages=1)
    assert readers['tv_roofline_pct'].read(run) is None
    run.trace = None
    assert readers['tv_roofline_pct'].read(run) is None
    run.device_kind = 'cpu'
    assert readers['tv_ms'].read(run) is not None
