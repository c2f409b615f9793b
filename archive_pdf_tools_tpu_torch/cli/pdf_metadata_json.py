# Copied from archive_pdf_tools_tpu/cli/pdf_metadata_json.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""pdf-metadata-json: analyse a PDF into a JSON report.

Schema parity with the reference's ``bin/pdf-metadata-json`` — the
output is consumed by external tooling (archive-hocr-tools'
``pdf-to-hocr -J``), so the key names and structure follow the
reference exactly (``bin/pdf-metadata-json:260-410``): top-level
``version`` / ``page_count`` / ``page_data`` / ``imagestack_image_format``;
per page ``page_number`` / ``page_rotation`` / ``page_language`` /
``page_rect`` / ``image_data`` (xref, width, height, depth, label,
bbox, transform, mode, mask) / ``estimated_scale`` / ``estimated_ppi``
/ ``estimated_default_render_res`` / ``hyperlinks`` /
``has_text_layer`` / ``page_without_images_color_mode``.

Colour mode is classified by rendering the page with images removed
through the in-tree rasterizer (reference semantics,
``bin/pdf-metadata-json:61-114``); image placements (bbox/transform in
top-left-origin coordinates, like fitz) come from a paint-free pass of
the same interpreter.
"""

import argparse
import io
import json
import re
import sys

import numpy as np
from PIL import Image

from ..const import VERSION
from ..pdf.reader import PdfReader

ANALYSIS_VERSION = '0.0.1'
SPEC_VERSION = '0.0.1'


def _round2(x):
    return round(float(x), 2)


def _round_list(v):
    return [_round2(x) for x in v]


def _classify_pixels(arr):
    """PIL-ish image mode from decoded pixels: '1' / 'L' / 'RGB'."""
    if arr.ndim == 3:
        if (arr[..., 0] == arr[..., 1]).all() and \
                (arr[..., 1] == arr[..., 2]).all():
            arr = arr[..., 0]
        else:
            return 'RGB'
    vals = np.unique(arr)
    if len(vals) <= 2:
        return '1'
    return 'L'


def _image_mode(reader, stream, sample_pixels):
    """PIL-style mode string for an image XObject (the reference reads
    it off a fitz pixmap, ``bin/pdf-metadata-json:116-190``)."""
    raw, filt, w, h, cs = reader.extract_image(stream)
    bpc = reader.resolve(stream.dict.get('BitsPerComponent'))
    if bpc == 1:
        return '1', bpc
    if sample_pixels and filt in ('DCTDecode', 'JPXDecode'):
        try:
            img = Image.open(io.BytesIO(raw))
            img.thumbnail((256, 256))
            return _classify_pixels(np.asarray(img.convert('RGB'))), bpc
        except Exception:
            pass
    if cs == 'DeviceRGB':
        return 'RGB', bpc
    if cs in ('DeviceGray', None):
        return 'L', bpc
    return 'RGB', bpc


def get_scale_from_image_data(image_data):
    """Reference formula (``bin/pdf-metadata-json:192-219``)."""
    if image_data:
        scale_x = 1.0
        scale_y = 1.0
        for info in image_data:
            bbox = info['bbox']
            width = info['width']
            height = info['height']
            bbox_w = abs(bbox[2] - bbox[0])
            bbox_h = abs(bbox[3] - bbox[1])
            if 0 < bbox_w < width:
                scale_x = width / bbox_w
            if 0 < bbox_h < height:
                scale_y = height / bbox_h
        return max(scale_x, scale_y)
    return 300.0 / 72.0


def get_recommended_image_format_from_page_data(page_data):
    """Reference policy (``bin/pdf-metadata-json:223-258``): 'RGB',
    'Grayscale' or 'Bitonal'."""
    page_colour_modes = [x['page_without_images_color_mode']
                         for x in page_data]
    if 'RGB' in page_colour_modes:
        return 'RGB'
    if not any(x.get('image_data') for x in page_data):
        if 'Grayscale' in page_colour_modes:
            return 'Grayscale'
        if 'Bitonal' in page_colour_modes:
            return 'Bitonal'
        return 'Bitonal'
    flattened = [im['mode'] for x in page_data
                 for im in x.get('image_data', [])]
    if 'RGB' in flattened or 'RGBA' in flattened:
        return 'RGB'
    if 'Grayscale' in page_colour_modes:
        return 'Grayscale'
    if 'L' in flattened or 'LA' in flattened:
        return 'Grayscale'
    if '1' in flattened:
        return 'Bitonal'
    return 'Bitonal'


def _bbox_from_transform(tm):
    xs = []
    ys = []
    for (ux, uy) in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xs.append(tm[0] * ux + tm[2] * uy + tm[4])
        ys.append(tm[1] * ux + tm[3] * uy + tm[5])
    return [min(xs), min(ys), max(xs), max(ys)]


def analyse_page(reader, idx, sample_pixels=True):
    from ..pdf.raster import page_colour_mode, image_placements
    page = reader.pages()[idx]
    page_w, page_h = reader.page_size(idx)

    page_data = {
        'page_number': idx,
        'page_rotation': int(reader.resolve(page.get('Rotate')) or 0),
        'page_language': None,
        'page_rect': _round_list([0, 0, page_w, page_h]),
    }

    try:
        records = image_placements(reader, idx)
    except Exception:
        # content stream unparsable: degrade to the resource inventory
        # with a full-page placement rather than reporting no images
        # (a successfully parsed page with undrawn images correctly
        # reports none, like the reference)
        records = [(name, (page_w, 0.0, 0.0, page_h, 0.0, 0.0),
                    num, stream)
                   for name, num, stream in reader.page_images(idx)]

    # draw-order records carry the stream resolved through the
    # resources ACTIVE at draw time, so images living inside Form
    # XObjects are inventoried too (and name collisions between page-
    # and form-level resources cannot mismatch)
    image_data = []
    seen = set()
    for name, tm, num, stream in records:
        key = (name, num)
        if key in seen:
            continue       # one entry per image, first placement wins
        seen.add(key)
        mode, bpc = _image_mode(reader, stream, sample_pixels)
        entry = {
            'xref': num,
            'width': int(reader.resolve(stream.dict['Width'])),
            'height': int(reader.resolve(stream.dict['Height'])),
            'depth': int(bpc or 8),
            'label': name,
            'bbox': _round_list(_bbox_from_transform(tm)),
            'transform': _round_list(tm),
            'mode': mode,
            'mask': None,
        }
        smask = reader.resolve(stream.dict.get('SMask'))
        if smask is not None:
            mmode, mbpc = _image_mode(reader, smask, sample_pixels)
            entry['mask'] = {
                'xref': None,
                'width': int(reader.resolve(smask.dict['Width'])),
                'height': int(reader.resolve(smask.dict['Height'])),
                'depth': int(mbpc or 8),
                'mode': mmode,
            }
        image_data.append(entry)

    scale = get_scale_from_image_data(image_data)
    if page_w * scale > 10000 or page_h * scale > 10000:
        scale = min(10000 / max(page_w, 1), 10000 / max(page_h, 1))
    page_data['estimated_scale'] = _round2(scale)
    page_data['estimated_ppi'] = int(72 * scale)
    page_data['estimated_default_render_res'] = _round_list(
        [v * scale for v in [0, 0, page_w, page_h]])

    link_uri = []
    annots = reader.resolve(page.get('Annots')) or []
    for aref in annots:
        a = reader.resolve(aref)
        if not a or str(reader.resolve(a.get('Subtype'))) != 'Link':
            continue
        action = reader.resolve(a.get('A')) or {}
        uri = reader.resolve(action.get('URI'))
        if uri is None:
            continue
        rect = [float(reader.resolve(v))
                for v in (reader.resolve(a.get('Rect')) or [0, 0, 0, 0])]
        link_uri.append({
            'uri': uri.decode('utf-8', 'replace')
                   if isinstance(uri, bytes) else str(uri),
            'xref': getattr(aref, 'num', None),
            'bbox': _round_list(rect),
        })

    # real glyph walk (Form XObjects included, string literals that
    # merely contain "Tj" excluded); content-stream regex as fallback
    try:
        from ..pdf.textextract import extract_page_glyphs
        glyphs, _w, _h = extract_page_glyphs(reader, idx, scale=0.25)
        page_data['has_text_layer'] = bool(glyphs)
    except Exception:
        contents = reader.page_contents(idx)
        page_data['has_text_layer'] = bool(
            re.search(rb'\bTj\b|\bTJ\b', contents))
    if link_uri:
        page_data['hyperlinks'] = link_uri
    if image_data:
        page_data['image_data'] = image_data

    try:
        page_data['page_without_images_color_mode'] = \
            page_colour_mode(reader, idx)
    except Exception:
        page_data['page_without_images_color_mode'] = 'Bitonal'

    return page_data


def analyse(path, sample_pixels=True):
    reader = PdfReader(path)
    res = {
        'version': {
            'analysis': ANALYSIS_VERSION,
            'spec': SPEC_VERSION,
            'framework': VERSION,
        },
        'page_count': reader.page_count(),
        'page_data': [analyse_page(reader, i, sample_pixels=sample_pixels)
                      for i in range(reader.page_count())],
    }
    res['imagestack_image_format'] = \
        get_recommended_image_format_from_page_data(res['page_data'])
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Analyse a PDF and emit a JSON metadata report.')
    parser.add_argument('infile')
    parser.add_argument('outfile', nargs='?', default=None)
    parser.add_argument('--no-sample', action='store_true',
                        help='skip decoding image pixels for mode detection')
    args = parser.parse_args(argv)

    report = analyse(args.infile, sample_pixels=not args.no_sample)
    out = json.dumps(report, indent=2)
    if args.outfile:
        with open(args.outfile, 'w') as fp:
            fp.write(out)
    else:
        print(out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
