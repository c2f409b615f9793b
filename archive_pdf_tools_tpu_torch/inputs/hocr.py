# Copied from archive_pdf_tools_tpu/inputs/hocr.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: lxml is the port's utils/etree_compat.py.
"""Streaming hOCR parser.

Self-contained replacement for the subset of `archive-hocr-tools`
(``hocr.parse``) that the reference imports (``recode.py:37-38``,
``pdfrenderer.py:22-25``): a constant-memory page iterator plus
word-data extraction into the paragraph/line/word dict structure the
renderer and MRC mask generator consume.

Built on lxml.etree.iterparse with element clearing, so arbitrarily
large hOCR files stream in O(page) memory.
"""

import io

from ..utils import etree_compat as etree

WRITING_DIRECTION_UNSPECIFIED = 0
WRITING_DIRECTION_LEFT_TO_RIGHT = 1
WRITING_DIRECTION_RIGHT_TO_LEFT = 2
WRITING_DIRECTION_TOP_TO_BOTTOM = 3

_XHTML = '{http://www.w3.org/1999/xhtml}'


def _title_props(elem):
    """Parse an hOCR ``title`` attribute into {prop: [values...]}."""
    props = {}
    title = elem.get('title') or ''
    for part in title.split(';'):
        part = part.strip()
        if not part:
            continue
        fields = part.split(' ')
        key = fields[0]
        vals = [f.strip('"') for f in fields[1:] if f]
        props[key] = vals
    return props


def _ocr_class(elem):
    return (elem.get('class') or '').strip()


def hocr_page_iterator(fp_or_path):
    """Yield ocr_page elements one at a time, freeing parsed subtrees."""
    if isinstance(fp_or_path, (str, bytes)):
        source = open(fp_or_path, 'rb')
    else:
        source = fp_or_path
    ctx = etree.iterparse(source, events=('end',), html=False,
                          recover=True, huge_tree=True)
    for _, elem in ctx:
        tag = elem.tag
        if isinstance(tag, str) and tag.endswith('div') \
                and _ocr_class(elem) == 'ocr_page':
            yield elem
            # free memory: clear element and preceding siblings
            elem.clear()
            parent = elem.getparent()
            if parent is not None:
                while elem.getprevious() is not None:
                    del parent[0]


def hocr_page_get_dimensions(page):
    """(width, height) from the page bbox."""
    props = _title_props(page)
    bbox = props.get('bbox')
    if bbox and len(bbox) == 4:
        return int(float(bbox[2])), int(float(bbox[3]))
    return None, None


def hocr_page_get_scan_res(page):
    """(x_res, y_res) from the page ``scan_res`` property, else (None, None)."""
    props = _title_props(page)
    res = props.get('scan_res')
    if res and len(res) >= 2:
        try:
            return int(float(res[0])), int(float(res[1]))
        except ValueError:
            return None, None
    return None, None


def _bbox_of(elem):
    props = _title_props(elem)
    bbox = props.get('bbox')
    if bbox and len(bbox) == 4:
        return [float(v) for v in bbox]
    return None


_PARA_CLASSES = ('ocr_par',)
_LINE_CLASSES = ('ocr_line', 'ocr_header', 'ocr_textfloat', 'ocr_caption')
_WORD_CLASSES = ('ocrx_word',)


def _iter_class(root, classes):
    for elem in root.iter():
        if isinstance(elem.tag, str) and _ocr_class(elem) in classes:
            yield elem


def hocr_page_to_word_data(page, scaler=1):
    """Extract [{'lines': [{'bbox', 'baseline', 'words': [...]}]}].

    Word fields: text, bbox, fontsize (x_fsize or line x_size, scaled),
    confidence (x_wconf, default 100), writing_direction (paragraph
    ``dir`` attribute).
    """
    paragraphs = []
    for par in _iter_class(page, _PARA_CLASSES):
        direction = {'ltr': WRITING_DIRECTION_LEFT_TO_RIGHT,
                     'rtl': WRITING_DIRECTION_RIGHT_TO_LEFT}.get(
                         (par.get('dir') or '').lower(),
                         WRITING_DIRECTION_UNSPECIFIED)
        lines = []
        for line in _iter_class(par, _LINE_CLASSES):
            lprops = _title_props(line)
            bbox = _bbox_of(line)
            if bbox is None:
                continue
            baseline = (0.0, 0.0)
            if 'baseline' in lprops and len(lprops['baseline']) >= 2:
                try:
                    baseline = (float(lprops['baseline'][0]),
                                float(lprops['baseline'][1]))
                except ValueError:
                    pass
            x_size = None
            if 'x_size' in lprops:
                try:
                    x_size = float(lprops['x_size'][0])
                except ValueError:
                    pass

            words = []
            for word in _iter_class(line, _WORD_CLASSES):
                wprops = _title_props(word)
                wbbox = _bbox_of(word)
                if wbbox is None:
                    continue
                text = ''.join(word.itertext())
                conf = 100
                if 'x_wconf' in wprops:
                    try:
                        conf = int(float(wprops['x_wconf'][0]))
                    except ValueError:
                        pass
                fsize = 0
                if 'x_fsize' in wprops:
                    try:
                        fsize = float(wprops['x_fsize'][0])
                    except ValueError:
                        pass
                elif x_size is not None:
                    fsize = x_size
                words.append({
                    'text': text,
                    'bbox': wbbox,
                    # archive-hocr-tools carries the scaled size as a
                    # float (the renderer accepts fractional Tf sizes,
                    # reference pdfrenderer.py:166-177); do not truncate.
                    'fontsize': fsize * scaler,
                    'confidence': conf,
                    'writing_direction': direction,
                })
            if words:
                lines.append({'bbox': bbox, 'baseline': baseline,
                              'words': words})
        if lines:
            paragraphs.append({'lines': lines})
    return paragraphs


def hocr_from_string(data):
    """Convenience: iterate pages of an in-memory hOCR document."""
    if isinstance(data, str):
        data = data.encode('utf-8')
    return hocr_page_iterator(io.BytesIO(data))
