"""Reading the window's ``torch.profiler`` trace (CPU and CUDA activity).

The benchmark opens the profiler around the window and marks each book
with a ``record_function`` span named ``book <n>``.  From the exported
Chrome trace this module takes the window (first book's start to last
book's end), the CUDA kernel intervals in it, their union (the device's
busy time, as ``chip_smoke.read_trace`` computes it), their summed time
by kernel name, and the idle gaps between them, each labelled by the
book span and the torch op of the main thread (the thread of the book
spans) that overlaps it most.
"""

import json

BOOK_SPAN = 'book '


def merge(intervals):
    """Sorted, disjoint unions of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Trace:
    """The window's kernels and host spans, times in seconds."""

    def __init__(self, events):
        spans = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
        books = [e for e in spans if e.get('cat') == 'user_annotation'
                 and str(e.get('name', '')).startswith(BOOK_SPAN)]
        if not books:
            raise ValueError('the trace has no book spans')
        self.t0 = min(e['ts'] for e in books)
        self.t1 = max(e['ts'] + e['dur'] for e in books)
        self.books = [(e['name'], e['ts'], e['ts'] + e['dur']) for e in books]
        self.kernels = [(e['name'], max(e['ts'], self.t0),
                         min(e['ts'] + e['dur'], self.t1))
                        for e in spans if e.get('cat') == 'kernel'
                        and e['ts'] < self.t1 and e['ts'] + e['dur'] > self.t0]
        main = books[0].get('tid')
        self.cpu_ops = [(e['name'], e['ts'], e['ts'] + e['dur'])
                        for e in spans if e.get('cat') == 'cpu_op'
                        and e.get('tid') == main]

    @classmethod
    def load(cls, path):
        with open(path) as fp:
            return cls(json.load(fp)['traceEvents'])

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e6

    def busy_s(self):
        """Seconds in which some kernel ran (the union of intervals)."""
        return sum(b - a for a, b in merge((a, b) for _, a, b in
                                           self.kernels)) / 1e6

    def kernel_s(self):
        """Summed kernel seconds (overlapping kernels each count)."""
        return sum(b - a for _, a, b in self.kernels) / 1e6

    def by_kernel(self, top=10):
        sums = {}
        for name, a, b in self.kernels:
            sums[name] = sums.get(name, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in sums.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top=10):
        """The longest gaps between kernels in the window, as
        [label, seconds], labelled by what the host was doing."""
        busy = merge((a, b) for _, a, b in self.kernels)
        edges = [self.t0] + [v for iv in busy for v in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            out.append([self.label(a, b), (b - a) / 1e6])
        return out

    def label(self, a, b):
        mid = (a + b) / 2
        book = next((n for n, s, e in self.books if s <= mid <= e),
                    'between books')
        best, most = None, 0
        for name, s, e in self.cpu_ops:
            ov = min(e, b) - max(s, a)
            if ov > most:
                best, most = name, ov
        return '%s: %s' % (book, best or 'main thread in no torch op '
                                         '(Python, decoders, waits)')
