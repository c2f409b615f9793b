"""The least time the window's work needs on the card (``roofline.py``:
each page's bytes at the memory rate or its operations at the float32
peak, the larger) over the summed time of every CUDA kernel in the traced
window."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s()
    if spent <= 0:
        return None
    peak = roofline.peak(run.device_kind)
    if peak is None:
        return None
    nbytes, ops = run.work()
    least, _ = roofline.least_seconds(nbytes, ops, peak)
    return 100.0 * least / spent
