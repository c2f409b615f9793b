"""How often the page decode runs ahead of the loader thread: the share
of the window's ``image_load`` records made off the ``loader`` thread
(on a decode thread, or in a worker process), in %.  0 where the loader
decodes every page itself, as a source PDF's pages; None where the
window holds no ``image_load`` record."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    loads = [r for r in win.records if r.name == 'image_load']
    if not loads:
        return None
    return 100.0 * sum(r.thread != 'loader' for r in loads) / len(loads)
