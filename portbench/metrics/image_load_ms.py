"""The page decode's wall time on the loader thread (the program's
``image_load`` timing key), over the window's pages."""

KEYS = ('image_load',)


def read(run):
    return run.breakdown_ms(KEYS)
