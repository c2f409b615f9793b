"""All pages of all books in the window over the window's wall time, from
the first book's call to the last book's written PDF."""


def read(run):
    return run.pages / run.window_s
