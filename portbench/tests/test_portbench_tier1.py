"""The Tier-1 and B7 readers (``metrics/tier1_ms.py``, ``tier1_cpu_ms``,
``dwt_roofline_pct``) on hand-made span records and kernel lists: their
values, only the window's books read, and None where their records are
absent (a Pillow configuration, a program without the spans, a run
without a trace)."""

import types

import pytest

from conftest import ROOT
from portbench import roofline, roofline_dwt
from portbench.registry import Benchmark
from portbench.run import Run
from portbench.trace import Trace

from archive_pdf_tools_tpu_torch.utils import spans

MS = 1000000   # ns
H100 = 'NVIDIA H100 80GB HBM3'
JTPU = {'bg_downsample': 3, 'jpeg2000_implementation': 'tpu'}


def _run(books, pages=2, shapes=None, flags=None, kind='cpu'):
    book = types.SimpleNamespace(pages=pages, shapes=shapes or [])
    run = Run(book, dict(flags or JTPU), kind)
    run.pdfs = ['book_%d.pdf' % i for i in range(books)]
    return run


def _book(call, t0, t1=True):
    """A book's records: the ``recode`` root, a ``fg_jp2`` on the pool
    with a ``t1_rescue`` inside it, and two ``t1_band`` on band threads
    (walls 30 + 50 + 20 ms, CPU 25 + 45 + 20 ms)."""
    R = spans.Record
    recs = [R(10 * call, 'recode', None, 'MainThread', 1, call,
              t0 * MS, (t0 + 1000) * MS, 600 * MS),
            R(10 * call + 1, 'fg_jp2', None, 'encode_0', 2, call,
              t0 * MS, (t0 + 200) * MS, 150 * MS)]
    if t1:
        recs += [R(10 * call + 2, 't1_rescue', 10 * call + 1, 'encode_0', 2,
                   call, (t0 + 100) * MS, (t0 + 120) * MS, 20 * MS),
                 R(10 * call + 3, 't1_band', None, 't1_band_0', 3, call,
                   t0 * MS, (t0 + 30) * MS, 25 * MS),
                 R(10 * call + 4, 't1_band', None, 't1_band_1', 4, call,
                   t0 * MS, (t0 + 50) * MS, 45 * MS)]
    return recs


def _read(monkeypatch, name, recs, run):
    monkeypatch.setattr(spans, 'collected', lambda: list(recs))
    return Benchmark(ROOT).reader(name).read(run)


@pytest.mark.parametrize('name,one,two', [('tier1_ms', 50.0, 25.0),
                                           ('tier1_cpu_ms', 45.0, 22.5)])
def test_tier1_values(monkeypatch, name, one, two):
    """Summed over threads, over the window's pages: a window of the last
    book reads its 2 pages; one of both books reads 4 pages, and the
    first book has no Tier-1 span."""
    recs = _book(1, 0, t1=False) + _book(2, 5000)
    assert _read(monkeypatch, name, recs, _run(1)) == one
    assert _read(monkeypatch, name, recs, _run(2)) == two


@pytest.mark.parametrize('name', ['tier1_ms', 'tier1_cpu_ms'])
@pytest.mark.parametrize('recs', ['empty', 'no_t1', 'no_root'])
def test_tier1_none(monkeypatch, name, recs):
    """None with an empty store, a window without Tier-1 spans (Pillow's
    layers, or a program without the spans) or without a recode span."""
    recs = {'empty': [], 'no_t1': _book(1, 0, t1=False),
            'no_root': [r for r in _book(1, 0) if r.name != 'recode']}[recs]
    assert _read(monkeypatch, name, recs, _run(1)) is None


def _ev(name, ts, dur, cat='kernel'):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'tid': 1}


def _trace(*kernels):
    return Trace([_ev('book 0', 0, 100000, 'user_annotation')]
                 + [_ev(n, ts, dur) for n, ts, dur in kernels])


def test_dwt_work():
    """A 30x16 page's layers, the fg at full size and the bg 9x5 (the
    thumbnail of --bg-downsample 3), each sample read as uint8 and
    written as an int32 band coefficient; none under Pillow's coder."""
    fw, fh = 16, 30
    bw, bh = roofline.thumb(16, 30, 3)
    assert (bw, bh) == (5, 9)
    px = fw * fh + bw * bh
    o = roofline.OPS
    nb, ops = roofline_dwt.page_work((30, 16, 3), JTPU)
    assert nb == 3 * px * 5
    assert ops == pytest.approx(3 * px * (o['dwt_level'] * 4 / 3
                                          + o['quantise']) + px * o['ict'])
    nb1, ops1 = roofline_dwt.page_work((30, 16), JTPU)
    assert nb1 == px * 5
    assert ops1 == pytest.approx(px * (o['dwt_level'] * 4 / 3
                                       + o['quantise']))
    assert roofline_dwt.page_work(
        (30, 16, 3), dict(JTPU, jpeg2000_implementation='pillow')) == (0, 0)
    assert roofline_dwt.book_work([(30, 16, 3), (30, 16)], JTPU) == (
        nb + nb1, pytest.approx(ops + ops1))


def test_dwt_roofline_pct():
    """The least time of the window's books' transforms over the summed
    time of the dwt_level kernels alone (other kernels not counted)."""
    shapes = [(3300, 2550, 3)] * 2
    run = _run(2, pages=2, shapes=shapes, kind=H100)
    run.trace = _trace(
        ('void dwt_level<unsigned char>(void const*, float*)', 10, 2000),
        ('void dwt_level<float>(void const*, float*)', 3000, 1000),
        ('void optimise_kernel<false>(unsigned int const*)', 5000, 9000))
    nb, ops = roofline_dwt.book_work(shapes, JTPU)
    least, which = roofline.least_seconds(2 * nb, 2 * ops,
                                          roofline.DEFAULT_PEAK)
    assert which == 'bytes'
    got = Benchmark(ROOT).reader('dwt_roofline_pct').read(run)
    assert got == pytest.approx(100.0 * least / 3000e-6)


@pytest.mark.parametrize('case', ['no_trace', 'no_dwt', 'unknown_card'])
def test_dwt_roofline_pct_none(case):
    run = _run(1, shapes=[(3300, 2550, 3)],
               kind='cpu' if case == 'unknown_card' else H100)
    if case != 'no_trace':
        run.trace = _trace(('void dwt_level<unsigned char>(void const*)',
                            10, 2000) if case != 'no_dwt' else
                           ('void despeckle_kernel<1>(unsigned int*)',
                            10, 2000))
    assert Benchmark(ROOT).reader('dwt_roofline_pct').read(run) is None
