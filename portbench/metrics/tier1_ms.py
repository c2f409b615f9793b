"""Tier-1's wall time in the ``-J tpu`` host coder: the ``t1_band``
spans (one band's native call, on the band threads an encoder starts)
and the ``t1_rescue`` spans (the re-encode of starved blocks), summed
over threads, over the window's pages.  None where the window holds no
such span: a Pillow configuration, or a program without them."""

from portbench import spans

NAMES = ('t1_band', 't1_rescue')


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    recs = [r for r in win.records if r.name in NAMES]
    if not recs:
        return None
    return sum(map(spans.wall_ms, recs)) / run.pages
