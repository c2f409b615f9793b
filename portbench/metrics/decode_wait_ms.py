"""The main thread's wait for the page loader: wall time of its
``batch_wait`` spans (``queue.get`` of the next batch), over the
window's pages.  What the decode costs the pipeline, where
``image_load_ms`` is what it costs the loader thread."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    return sum(map(spans.wall_ms, win.main(('batch_wait',)))) / run.pages
