# Copied from archive_pdf_tools_tpu/pdf/textlayer.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Invisible text layer: hOCR word data -> PDF content stream operators.

Re-derivation of Tesseract's text placement algorithm as used by the
reference renderer (``pdfrenderer.py:61-207,449-544``, itself a port of
tesseract pdfrenderer.cpp): words are projected onto the OCR baseline,
an affine per writing direction rotates text space, horizontal stretch
(Tz) makes the fixed-advance glyphless font span the detected word box,
and text renders in mode 3 (invisible) above the page image.

Geometry conventions: hOCR coordinates are scan pixels with y down; PDF
text space is points with y up; ``ppi`` converts (72/ppi scale).
"""

import math

from ..inputs.hocr import (WRITING_DIRECTION_UNSPECIFIED,
                           WRITING_DIRECTION_LEFT_TO_RIGHT,
                           WRITING_DIRECTION_RIGHT_TO_LEFT)
from .fonts import K_CHAR_WIDTH


def _prec(x):
    """Quantize to 1/1000 (``pdfrenderer.py:449-454``); avoids scientific
    notation creeping into the PDF."""
    a = round(x * 1000.0) / 1000.0
    return 0.0 if a == 0 else a


def _fmt(x):
    s = ('%.8f' % x).rstrip('0').rstrip('.')
    return s if s not in ('', '-0') else '0'


def _dist2(x1, y1, x2, y2):
    return (x2 - x1) ** 2 + (y2 - y1) ** 2


def clip_baseline(ppi, x1, y1, x2, y2):
    """Flatten nearly-horizontal baselines (``pdfrenderer.py:516-526``):
    when the rise is under 2/72 inch and the run over it, use the mean y."""
    rise = abs(y2 - y1) * 72
    run = abs(x2 - x1) * 72
    if rise < 2 * ppi and 2 * ppi < run:
        y1 = y2 = (y1 + y2) / 2
    return x1, y1, x2, y2


def word_baseline(direction, ppi, page_height, word_box, line_seg):
    """Project the word origin onto the baseline segment; returns PDF-space
    (x, y) and the word length in points (``pdfrenderer.py:461-493``)."""
    wx1, wy1, wx2, wy2 = word_box
    lx1, ly1, lx2, ly2 = line_seg
    if direction == WRITING_DIRECTION_RIGHT_TO_LEFT:
        wx1, wx2 = wx2, wx1
        wy1, wy2 = wy2, wy1

    l2 = float(_dist2(lx1, ly1, lx2, ly2))
    if l2 == 0:
        x, y = lx1, ly1
    else:
        t = ((wx1 - lx2) * (lx2 - lx1) + (wy1 - ly2) * (ly2 - ly1)) / l2
        x = lx2 + t * (lx2 - lx1)
        y = ly2 + t * (ly2 - ly1)

    length = math.sqrt(_dist2(wx1, wy1, wx2, wy2)) * 72.0 / ppi
    return x * 72.0 / ppi, page_height - y * 72.0 / ppi, length


def affine_matrix(direction, lx1, ly1, lx2, ly2):
    """Rotation from the baseline angle, mirrored for RTL
    (``pdfrenderer.py:495-513``)."""
    theta = math.atan2(float(ly1 - ly2), float(lx2 - lx1))
    a, b = math.cos(theta), math.sin(theta)
    c, d = -b, a
    if direction == WRITING_DIRECTION_RIGHT_TO_LEFT:
        a, b = -a, -b
    return a, b, c, d


def codepoint_utf16be(code):
    """Codepoint -> UTF-16BE hex (``pdfrenderer.py:529-544``); surrogate
    range and >10FFFF are dropped."""
    if (0xD7FF < code < 0xE000) or code > 0x10FFFF:
        return None
    if code < 0x10000:
        return '%04X' % code
    a = code - 0x10000
    return '%04X%04X' % ((0x03FF & (a >> 10)) + 0xD800,
                         (0x03FF & a) + 0xDC00)


def page_text_ops(word_data, width, height, ppi, render_text_lines=False):
    """Build the text-drawing operator bytes for one page
    (semantics of ``pdfrenderer.py:61-207``)."""
    ops = []
    old_x = old_y = 0.0
    old_direction = WRITING_DIRECTION_LEFT_TO_RIGHT
    a, b, c, d = 1.0, 0.0, 0.0, 1.0

    for paragraph in word_data:
        partext = ''.join(ch for line in paragraph['lines']
                          for word in line['words'] for ch in word['text'])
        if partext.strip() == '':
            continue

        ops.append(b'BT\n0 Tr' if render_text_lines else b'BT\n3 Tr')
        old_fontsize = 0
        new_block = True

        for line in paragraph['lines']:
            bx1, by1, bx2, by2 = line['bbox']
            slope, const = line['baseline']
            x1, y1 = bx1, by2 + const
            x2 = bx2
            y2 = y1 + slope * (x2 - x1)
            seg = clip_baseline(ppi, x1, y1, x2, y2)

            direction = line['words'][0]['writing_direction'] \
                if line['words'] else WRITING_DIRECTION_LEFT_TO_RIGHT
            if direction == WRITING_DIRECTION_UNSPECIFIED:
                direction = WRITING_DIRECTION_LEFT_TO_RIGHT

            for word in line['words']:
                x, y, word_length = word_baseline(
                    direction, ppi, height, word['bbox'], seg)

                if direction != old_direction or new_block:
                    a, b, c, d = affine_matrix(direction, *seg)
                    ops.append(b' %s %s %s %s %s %s Tm ' % tuple(
                        _fmt(_prec(v)).encode('ascii')
                        for v in (a, b, c, d, x, y)))
                    new_block = False
                else:
                    dx, dy = x - old_x, y - old_y
                    ops.append(b' %s %s Td ' % (
                        _fmt(_prec(dx * a + dy * b)).encode('ascii'),
                        _fmt(_prec(dx * c + dy * d)).encode('ascii')))

                old_x, old_y = x, y
                old_direction = direction

                fontsize = word['fontsize']
                if fontsize <= 0:
                    fontsize = abs(seg[3] - seg[1])  # line height
                    if fontsize <= 0:
                        fontsize = 8

                if fontsize != old_fontsize:
                    ops.append(b'/f-0-0 %s Tf ' %
                               _fmt(fontsize).encode('ascii'))
                    old_fontsize = fontsize

                hex_word = ''
                n_cps = 0
                for ch in word['text']:
                    enc = codepoint_utf16be(ord(ch))
                    if enc is not None:
                        hex_word += enc
                        n_cps += 1
                hex_word += '0020'
                n_cps += 1

                if word_length > 0 and n_cps > 0:
                    stretch = K_CHAR_WIDTH * _prec(
                        100.0 * word_length / (fontsize * n_cps))
                    ops.append(b'%s Tz [ <%s> ] TJ' % (
                        _fmt(stretch).encode('ascii'),
                        hex_word.encode('ascii')))
            ops.append(b' \n')
        ops.append(b'ET\n')
    return b''.join(ops)
