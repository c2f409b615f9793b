"""Time the thread that drives the card could run but did not: over
``recode``'s direct children on its thread other than the two waits on
other threads (``batch_wait``, ``encode_wait``), wall minus thread CPU
time, over the window's pages.  Interpreter-lock waits and blocking
device syncs show here."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    ns = sum((r.end_ns - r.start_ns) - r.cpu_ns for r in win.children()
             if r.name not in spans.WAITS)
    return ns / 1e6 / run.pages
