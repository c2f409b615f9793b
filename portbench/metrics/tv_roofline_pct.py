"""tv_roofline_pct (%): the least time of the window's TV mask denoise
(``roofline_tv.py``: the mask and each iteration's float32 state moved
once at the memory rate, or the operations at the float32 peak, the
larger) over the summed device time of the kernels that run inside the
window's ``tv_denoise`` spans.

The spans are the program's (``portbench/spans.py``), timed on the
host's monotonic clock; the kernels are the trace's, on the profiler's.
Each book's spans are moved onto the trace's clock by the distance
between the trace's ``book <n>`` span and the book's ``recode`` span,
which opens first thing inside it (a few microseconds later).  None
without a trace, without ``tv_denoise`` spans (another denoise mode, or
a program without the span), without kernels in them (the CPU), when
the books of the trace and of the spans do not pair, or on a card whose
peaks ``roofline.py`` does not know."""

import bisect

from portbench import roofline, roofline_tv, spans
from portbench.trace import merge


def tv_intervals(run, win):
    """The window's ``tv_denoise`` spans on the trace's clock (us), merged;
    None where the books do not pair."""
    books = sorted(run.trace.books, key=lambda b: b[1])
    roots = sorted(win.roots, key=lambda r: r.start_ns)
    if len(books) != len(roots):
        return None
    shift = {root.call: start - root.start_ns / 1e3
             for (_, start, _), root in zip(books, roots)}
    return merge((r.start_ns / 1e3 + shift[r.call],
                  r.end_ns / 1e3 + shift[r.call])
                 for r in win.records if r.name == 'tv_denoise')


def kernel_seconds(kernels, intervals):
    """Summed seconds of the kernels (name, start, end in us) inside the
    disjoint sorted intervals (us)."""
    kernels = sorted((a, b) for _, a, b in kernels)
    starts = [a for a, _ in kernels]
    longest = max((b - a for a, b in kernels), default=0)
    total = 0.0
    for lo, hi in intervals:
        i = bisect.bisect_left(starts, lo - longest)
        while i < len(kernels) and kernels[i][0] < hi:
            a, b = kernels[i]
            total += max(0.0, min(b, hi) - max(a, lo))
            i += 1
    return total / 1e6


def read(run):
    if run.trace is None:
        return None
    win = spans.window(run)
    if win is None or not any(r.name == 'tv_denoise' for r in win.records):
        return None
    peak = roofline.peak(run.device_kind)
    if peak is None:
        return None
    intervals = tv_intervals(run, win)
    if not intervals:
        return None
    spent = kernel_seconds(run.trace.kernels, intervals)
    if spent <= 0:
        return None
    nbytes, ops = roofline_tv.book_work(run.book.shapes, run.recode_flags)
    least, _ = roofline.least_seconds(nbytes * len(run.pdfs),
                                      ops * len(run.pdfs), peak)
    return 100.0 * least / spent
