"""tv_ms (ms/page): the wall time of the window's ``tv_denoise`` spans
(``ops/tv.py``: one a call of the TV mask denoise, around its 100
iterations), over the window's pages.  None where the window holds no
such span: a configuration whose denoise mode is not ``bregman``, or a
program without the span."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    recs = [r for r in win.records if r.name == 'tv_denoise']
    if not recs:
        return None
    return sum(map(spans.wall_ms, recs)) / run.pages
