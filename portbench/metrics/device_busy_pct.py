"""The union of the CUDA kernel intervals over the traced window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    busy = run.trace.busy_s()
    return 100.0 * busy / run.trace.window_s if busy > 0 else None
