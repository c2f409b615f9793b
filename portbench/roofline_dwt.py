"""The least work of B7, the ``-J tpu`` layer transform
(``csrc/dwt97.cu``: the DC shift or the ICT, the 9/7 wavelet and the
quantiser, one ``dwt_level`` launch a level), for ``dwt_roofline_pct``.

Counted from the page shapes and the configuration's flags, as
``roofline.py`` counts the whole step's work, never from the kernel:
each fg and bg layer sample read once as uint8 and each quantised band
coefficient written once as int32 (the bands hold as many coefficients
as the layer has samples); operations ``roofline.OPS``'s ``dwt_level``
over the level pyramid (4/3 of the samples), the quantiser, and on RGB
layers the ICT a pixel.
"""

from .roofline import OPS, thumb

LAYER_BYTES = 1     # a uint8 sample
BAND_BYTES = 4      # an int32 quantised coefficient


def page_work(shape, recode_flags):
    """(bytes, operations) of one page's fg and bg transforms; (0, 0)
    where the configuration does not run the in-tree coder or makes no
    layers (``--bw-pdf``)."""
    if recode_flags.get('jpeg2000_implementation') != 'tpu' \
            or recode_flags.get('force_1bit_output'):
        return 0, 0
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 1
    fw, fh = thumb(w, h, recode_flags.get('fg_downsample'))
    bw, bh = thumb(w, h, recode_flags.get('bg_downsample'))
    pixels = fw * fh + bw * bh
    samples = pixels * c
    nbytes = samples * (LAYER_BYTES + BAND_BYTES)
    ops = samples * (OPS['dwt_level'] * 4 / 3 + OPS['quantise'])
    if c == 3:
        ops += pixels * OPS['ict']
    return nbytes, ops


def book_work(shapes, recode_flags):
    """(bytes, operations) of the transforms of one book's pages."""
    nbytes = ops = 0
    for shape in shapes:
        b, o = page_work(shape, recode_flags)
        nbytes += b
        ops += o
    return nbytes, ops
