"""The PDF writer on the main thread: wall time of the ``text_pages``
(pass 1), ``page_image_insertion`` and ``pdf_write`` (``write_pdfa``
through ``save``) spans, over the window's pages."""

from portbench import spans

NAMES = ('text_pages', 'page_image_insertion', 'pdf_write')


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    return sum(map(spans.wall_ms, win.main(NAMES))) / run.pages
