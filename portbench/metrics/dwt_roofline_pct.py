"""B7's share of its roofline: the least time of the window's layer
transforms (``roofline_dwt.py``: the layers read once and the bands
written once at the memory rate, or the operations at the float32 peak,
the larger) over the summed device time of the traced window's
``dwt_level`` kernels.  None without a trace, without such kernels (a
Pillow configuration) or on a card whose peaks ``roofline.py`` does not
know."""

from portbench import roofline, roofline_dwt

KERNEL = 'dwt_level'


def read(run):
    if run.trace is None:
        return None
    spent = sum(s for name, s in run.trace.by_kernel(top=None)
                if KERNEL in name)
    if spent <= 0:
        return None
    peak = roofline.peak(run.device_kind)
    if peak is None:
        return None
    nbytes, ops = roofline_dwt.book_work(run.book.shapes, run.recode_flags)
    least, _ = roofline.least_seconds(nbytes * len(run.pdfs),
                                      ops * len(run.pdfs), peak)
    return 100.0 * least / spent
