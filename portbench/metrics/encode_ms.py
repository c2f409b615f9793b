"""The host encoders' wall time, summed over the encode pool's threads
(``fg_jp2 + bg_jp2 + mask_jbig2``), over the window's pages.  It holds
each thread's waits for the interpreter lock (and with ``-J tpu`` for the
band copy)."""

KEYS = ('fg_jp2', 'bg_jp2', 'mask_jbig2')


def read(run):
    return run.breakdown_ms(KEYS)
