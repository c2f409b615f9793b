"""The host's one worker budget (``utils/workers.py``): every width from
one core count, at the formulas the pools were sized by before they
shared it, ``threads=`` resolved as before, the thread pools bound to
the calling ``recode()`` call, and a worker's timed span stored under
the waiting thread's call."""

import os
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from archive_pdf_tools_tpu_torch.utils import spans
from archive_pdf_tools_tpu_torch.utils import workers


@pytest.mark.parametrize('affinity', [True, False])
@pytest.mark.parametrize('n', [1, 2, 3, 8, 64])
def test_every_width_from_one_core_count(monkeypatch, n, affinity):
    """The affinity and the CPU count faked at ``n`` cores; without an
    affinity call the CPU count is the core count."""
    if affinity:
        monkeypatch.setattr(os, 'sched_getaffinity',
                            lambda pid: set(range(n)), raising=False)
    else:
        monkeypatch.delattr(os, 'sched_getaffinity', raising=False)
    monkeypatch.setattr(os, 'cpu_count', lambda: n)
    assert workers.cores() == n
    assert workers.decode_width() == min(4, max(1, n // 2))
    assert workers.jp2_decode_width() == min(8, n)
    assert workers.encode_width() == min(4, max(2, n))
    assert workers.tier1_width() == min(8, n)
    for threads in (None, 0, 1, 2, 5, 16):
        assert workers.encode_width(threads) == (
            max(1, threads) if threads else min(4, max(2, n)))
        assert workers.tier1_width(threads) == (
            min(8, n) if threads is None else threads)


def test_affinity_is_the_core_count(monkeypatch):
    """A process held to 3 of 64 cores sizes its pools by the 3."""
    monkeypatch.setattr(os, 'sched_getaffinity', lambda pid: {0, 1, 2},
                        raising=False)
    monkeypatch.setattr(os, 'cpu_count', lambda: 64)
    assert workers.cores() == 3
    assert (workers.decode_width(), workers.jp2_decode_width(),
            workers.encode_width(), workers.tier1_width()) == (1, 3, 3, 3)


def test_no_affinity_and_no_cpu_count_is_one_core(monkeypatch):
    monkeypatch.delattr(os, 'sched_getaffinity', raising=False)
    monkeypatch.setattr(os, 'cpu_count', lambda: None)
    assert workers.cores() == 1


def test_bound_threads_take_the_calling_threads_call():
    with spans.call('recode') as root:
        with workers.bound_threads('decode', 3) as pool:
            got = list(pool.map(
                lambda _: (threading.current_thread().name,
                           spans.current_call()), range(6)))
    assert {call for _, call in got} == {root.call_id}
    assert all(name.startswith('decode_') for name, _ in got)
    assert spans.current_call() is None


def test_take_stores_the_workers_span_under_the_call():
    done = workers.timed(sum, [1, 2, 3])
    assert done.value == 6 and done.pid == os.getpid()
    assert 0 <= done.cpu_ns <= done.end_ns - done.start_ns
    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.call('recode') as root:
                assert workers.take(done, 'jp2_pillow', 'encode-proc') == 6
        rec, = [r for r in spans.collected() if r.name == 'jp2_pillow']
    finally:
        spans.clear()
    assert rec.thread == 'encode-proc-%d' % done.pid
    assert (rec.thread_id, rec.call, rec.start_ns, rec.end_ns, rec.cpu_ns) \
        == (done.pid, root.call_id, done.start_ns, done.end_ns, done.cpu_ns)
