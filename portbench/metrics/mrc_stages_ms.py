"""The batch stages' wall time after a device synchronise each (the
program's timing keys of ``mrc/api.py``), summed, over the window's
pages.  A key is there only where the path runs it."""

KEYS = ('hocr_mask_gen', 'threshold', 'fast_denoise', 'fg_partial_blur',
        'bg_partial_blur', 'fg_downsample', 'bg_downsample', 'mask_fetch')


def read(run):
    return run.breakdown_ms(KEYS)
