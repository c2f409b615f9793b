"""The card's peaks and the least work a recode needs on it.

The work is computed from page shapes, line boxes and the
configuration's flags, never from the kernels that do it, so a kernel
that is fused, split or replaced is judged against the same work.  Each
input byte is read once and each output byte written once; an operation
is a float or integer arithmetic operation a pixel needs in the plain
algorithm, counted with running window sums (see ``OPS``).
"""

import math

from .reference.mrc import denoise_mode, thumbnail_size

# NVIDIA H100 SXM (data sheet): HBM3 bandwidth, and float32 outside the
# tensor cores (every stage here is scalar float32 or integer work)
PEAKS = {
    'NVIDIA H100 80GB HBM3': {'bytes_per_s': 3.35e12, 'ops_per_s': 67e12},
}
DEFAULT_PEAK = PEAKS['NVIDIA H100 80GB HBM3']

# operations a pixel needs in each stage of the plain algorithm
OPS = {
    'gray': 5,           # ITU-R 601 luma in fixed point
    'noise': 16,         # two 4-tap db2 passes over the middle half
    'sauvola': 16,       # running sums of x and x^2 in two axes, the test
    'paste': 1,
    'despeckle': 10,     # the neighbourhood count and the threshold
    'fill': 12,          # FIR and IIR running sums, the division, select
    'dwt_level': 18,     # four lifts and a scaling, in two axes
    'quantise': 1,
    'ict': 9,            # the irreversible colour transform
}


def blur_radius(noise_sigma):
    """The blur radius the page's noise needs: int(4 * 0.1 * sigma + 0.5)."""
    return int(math.floor(4.0 * 0.1 * noise_sigma + 0.5))


def thumb(w, h, factor):
    """The size of a w x h layer after ``--bg-downsample`` /
    ``--fg-downsample`` ``factor``: PIL's aspect fit into (w//f, h//f)."""
    if not factor:
        return w, h
    bw, bh = int(w / factor), int(h / factor)
    if bw <= 0 or bh <= 0:
        return w, h
    return thumbnail_size(w, h, bw, bh) or (w, h)


def page_work(shape, boxes, noise_sigma, recode_flags):
    """(bytes, operations) one page of ``shape`` needs on the card: the
    mask (the despeckle under ``--denoise-mask fast`` only), then the
    layers, which ``--bw-pdf`` (``force_1bit_output``) does not make."""
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 1
    px = h * w
    r = blur_radius(noise_sigma)
    fast = denoise_mode(recode_flags) == 'fast'
    nbytes = px * c + h * -(-w // 8)
    ops = px * (OPS['gray'] * (c == 3) + 4 * (2 * r + 1) + OPS['sauvola']
                + OPS['paste'] + OPS['despeckle'] * fast)
    ops += (h // 2) * (w // 2) * OPS['noise']
    area = sum((x1 - x0) * (y1 - y0) for x0, y0, x1, y1 in boxes)
    ops += 2 * area * OPS['sauvola']
    if recode_flags.get('force_1bit_output'):
        return nbytes, ops
    fw, fh = thumb(w, h, recode_flags.get('fg_downsample'))
    bw, bh = thumb(w, h, recode_flags.get('bg_downsample'))
    layers = (fw * fh + bw * bh) * c
    nbytes += layers
    ops += px * 2 * OPS['fill'] * c
    for (lw, lh), f in ((thumb(w, h, recode_flags.get('fg_downsample')),
                         recode_flags.get('fg_downsample')),
                        ((bw, bh), recode_flags.get('bg_downsample'))):
        if f and (lw, lh) != (w, h):
            taps = 4 * f
            ops += 2 * taps * c * (h * lw + lh * lw)
    if recode_flags.get('jpeg2000_implementation') == 'tpu':
        # the wavelet reads both layers once and writes their bands once
        nbytes += 2 * layers
        ops += layers * (OPS['dwt_level'] * 4 / 3 + OPS['quantise'])
        if c == 3:
            ops += (fw * fh + bw * bh) * OPS['ict']
    return nbytes, ops


def peak(kind):
    """The peaks of a card by its ``torch.cuda.get_device_name``, or None
    for a card this table does not know."""
    return PEAKS.get(kind)


def least_seconds(nbytes, ops, peak=DEFAULT_PEAK):
    """(seconds, 'bytes' or 'operations'): the larger of the two bounds."""
    tb = nbytes / peak['bytes_per_s']
    to = ops / peak['ops_per_s']
    return (tb, 'bytes') if tb >= to else (to, 'operations')
