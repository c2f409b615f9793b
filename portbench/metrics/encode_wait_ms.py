"""The main thread's wait for the encode pool: wall time of its
``encode_wait`` spans (``fut.result()`` of the next page in page order,
under back-pressure and in the final drain), over the window's pages."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    return sum(map(spans.wall_ms, win.main(('encode_wait',)))) / run.pages
