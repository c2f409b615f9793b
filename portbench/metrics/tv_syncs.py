"""tv_syncs (syncs/page): the count of the window's ``tv_sync`` spans
(``ops/tv.py``: each a read of the device by the host inside the TV mask
denoise, which waits for the device's queue to drain), over the window's
pages.  None where the window holds no ``tv_denoise`` span: a
configuration whose denoise mode is not ``bregman``, or a program
without the spans."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    if not any(r.name == 'tv_denoise' for r in win.records):
        return None
    return sum(r.name == 'tv_sync' for r in win.records) / run.pages
