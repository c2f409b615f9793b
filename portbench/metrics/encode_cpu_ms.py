"""The host encoders' own CPU: the thread CPU time of the ``mask_*``,
``fg_jp2`` and ``bg_jp2`` spans on any thread, over the window's pages.
Beside ``encode_ms`` (the same spans' wall time) it splits the encode
from its waits for the interpreter lock.  It leaves out threads an
encoder starts itself (``-J tpu``'s Tier-1 band threads, JBIG2 bands)
and counts a CUDA event wait that spins as CPU."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    ns = sum(r.cpu_ns for r in win.records
             if r.name.startswith('mask_') or r.name in ('fg_jp2', 'bg_jp2'))
    return ns / 1e6 / run.pages
