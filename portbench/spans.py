"""What the span readers share: the program's span store
(``archive_pdf_tools_tpu_torch/utils/spans.py``) cut to the window.

The store fills only while a ``torch.profiler`` session is open, so in a
``--trace 1`` run it holds the window's books and nothing of the warm-up.
A window's books are the last ``len(run.pdfs)`` ``recode`` root spans in
it.  Each reader sums its spans over them and divides by ``run.pages``;
where the program keeps no store, or the store holds no ``recode`` span,
it reads None.
"""

# recode's direct children on its own thread that wait on another thread
WAITS = ('batch_wait', 'encode_wait')


class Window:
    """The window's records: ``roots`` (one ``recode`` span a book) and
    ``records`` (every record of those calls, on any thread)."""

    def __init__(self, roots, records):
        self.roots = roots
        self.records = records
        self._main = {r.call: r.thread_id for r in roots}

    def main(self, names):
        """Records of these names on the thread of their call's root."""
        return [r for r in self.records if r.name in names
                and self._main[r.call] == r.thread_id]

    def children(self):
        """The roots' direct children on the roots' threads."""
        ids = {r.id for r in self.roots}
        return [r for r in self.records if r.parent in ids
                and self._main[r.call] == r.thread_id]


def store():
    """The program's records, or None where the program has no store."""
    try:
        from archive_pdf_tools_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.collected()


def window(run):
    """The window's ``Window``, or None."""
    records = store()
    if not records or not run.pdfs:
        return None
    roots = sorted((r for r in records if r.name == 'recode'),
                   key=lambda r: r.start_ns)[-len(run.pdfs):]
    if not roots:
        return None
    calls = {r.call for r in roots}
    return Window(roots, [r for r in records if r.call in calls])


def wall_ms(r):
    return (r.end_ns - r.start_ns) / 1e6
