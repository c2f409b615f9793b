"""Bytes of all PDFs written in the window over their pages: what the
Archive stores for a page."""

import os


def read(run):
    return sum(os.path.getsize(p) for p in run.pdfs) / run.pages
