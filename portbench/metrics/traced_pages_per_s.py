"""All pages of all books in the traced window over its wall time, from
the first book's call to the last book's written PDF: ``pages_per_s`` with
the profiler on, kept per layer in the cells whose runs spread too widely
to hold it end to end."""


def read(run):
    return run.pages / run.window_s
