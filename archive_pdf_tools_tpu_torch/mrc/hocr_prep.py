# Copied from archive_pdf_tools_tpu/mrc/hocr_prep.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Host-side hOCR line preparation for the batched MRC decompose.

Reproduces the line-filter policy of the reference's ``create_hocr_mask``
(``mrc.py:194-221``): join word texts, average confidences, drop empty /
low-confidence (<20) lines, scale bboxes by the page downsample factor,
drop degenerate and out-of-image boxes (with the same stderr warnings).

Output is a flat numpy description consumed by the device kernels: a
per-page int32 line-id map (0 = background; boxes painted in document
order so overlaps resolve to the *last* line, matching the reference's
sequential overwrite) plus per-line bbox arrays.
"""

import sys

import numpy as np


def prepare_lines(hocr_word_data, image_width, image_height, downsample=None):
    """Filter and scale line boxes for one page.

    Returns a list of (top, bottom, left, right) int tuples in order.
    """
    boxes = []
    for paragraph in hocr_word_data:
        for line in paragraph['lines']:
            words = line['words']
            line_text = ' '.join(w['text'] for w in words)
            confs = [w['confidence'] for w in words]
            line_conf = sum(confs) / len(confs) if confs else 0

            if line_text.strip() == '' or line_conf < 20:
                continue

            coords = line['bbox']
            if downsample is not None:
                coords = [int(c / downsample) for c in coords]
            else:
                coords = [int(c) for c in coords]
            left, top, right, bottom = coords

            if left == right or top == bottom:
                continue
            if left >= right or top >= bottom:
                print('Invalid bounding box: (%d, %d, %d, %d)'
                      % (left, top, right, bottom), file=sys.stderr)
                continue
            if (left < 0 or right > image_width or top < 0
                    or bottom > image_height):
                print('Invalid bounding box outside image: (%d, %d, %d, %d)'
                      % (left, top, right, bottom), file=sys.stderr)
                continue
            boxes.append((top, bottom, left, right))
    return boxes


def paint_line_ids(page_boxes, h, w, max_lines):
    """Build batched line-id maps and box arrays.

    Args:
      page_boxes: list (len B) of per-page box lists from prepare_lines.
      h, w: padded page height/width.
      max_lines: static per-batch line capacity (boxes beyond are dropped
                 with a warning).

    Returns (line_id_map (B,H,W) int32, boxes (4, max_lines+1) int32
    [t,b,l,r; slot 0 is the background dummy], n_lines).
    """
    b = len(page_boxes)
    id_map = np.zeros((b, h, w), np.int32)
    t = np.zeros((max_lines + 1,), np.int32)
    bo = np.zeros((max_lines + 1,), np.int32)
    l = np.zeros((max_lines + 1,), np.int32)
    r = np.zeros((max_lines + 1,), np.int32)
    # dummy slot 0: degenerate box so background pixels get count>=1
    bo[0] = 1
    r[0] = 1

    lid = 0
    for page, boxes in enumerate(page_boxes):
        for (top, bottom, left, right) in boxes:
            if lid >= max_lines:
                print('hocr line capacity exceeded; dropping line',
                      file=sys.stderr)
                continue
            lid += 1
            id_map[page, top:bottom, left:right] = lid
            t[lid], bo[lid], l[lid], r[lid] = top, bottom, left, right
    return id_map, np.stack([t, bo, l, r]), lid
