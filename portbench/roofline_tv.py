"""The least work of the TV mask denoise (``--denoise-mask bregman``:
100 split-Bregman iterations, ``ops/tv.py``), for ``tv_roofline_pct``.

Counted from the page shapes and the configuration's flags, as
``roofline.py`` counts the whole step's work, never from the program:
the mask read once and the denoised mask written once (a byte a pixel
each), and each iteration one pass over its state: the image ``f`` read,
and ``u``, ``dy``, ``dx``, ``by``, ``bx`` read and written, in float32
(44 bytes a pixel an iteration).  Operations: ``OPS`` a pixel an
iteration in the plain algorithm (``reference/denoise_bregman.py``), and
the conversion and the threshold a pixel.

This counts a kernel that keeps no state on chip between iterations.  A
kernel that holds several iterations on chip moves fewer bytes than this
bound allows for: a ``benchmark`` PR then has to count its work anew.
"""

from .reference.denoise_bregman import ITERATIONS
from .reference.mrc import denoise_mode

MASK_BYTES = 1          # a bool pixel, read once and written once
PLANE_BYTES = 4         # a float32 sample
STATE_PLANES = 5        # u, dy, dx, by, bx: read and written
# operations a pixel an iteration: the 4-neighbour sum 3, d - b 2, the
# divergence 3, the u-step 5, the two gradients 4, the squared norm 3
# and its root 1, the shrink factor 4, d 2, b 4
OPS = 31
EDGE_OPS = 2            # the float conversion and the threshold


def page_work(shape, recode_flags):
    """(bytes, operations) of one page's TV denoise; (0, 0) where the
    configuration's denoise mode is not ``bregman``."""
    if denoise_mode(recode_flags) != 'bregman':
        return 0, 0
    px = shape[0] * shape[1]
    per_iter = PLANE_BYTES * (1 + 2 * STATE_PLANES)
    nbytes = px * (2 * MASK_BYTES + ITERATIONS * per_iter)
    ops = px * (ITERATIONS * OPS + EDGE_OPS)
    return nbytes, ops


def book_work(shapes, recode_flags):
    """(bytes, operations) of the TV denoise of one book's pages."""
    nbytes = ops = 0
    for shape in shapes:
        b, o = page_work(shape, recode_flags)
        nbytes += b
        ops += o
    return nbytes, ops
