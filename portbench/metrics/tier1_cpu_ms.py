"""Tier-1's own CPU: the thread CPU time of the ``t1_band`` and
``t1_rescue`` spans, over the window's pages.  Beside ``tier1_ms`` (the
same spans' wall time) it shows how far the band threads wait for a
core.  None where the window holds no such span."""

from portbench import spans

NAMES = ('t1_band', 't1_rescue')


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    recs = [r for r in win.records if r.name in NAMES]
    if not recs:
        return None
    return sum(r.cpu_ns for r in recs) / 1e6 / run.pages
