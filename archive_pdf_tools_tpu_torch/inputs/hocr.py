"""Streaming hOCR reader on the standard library's ElementTree.

Same functions and the same word-data structure as the JAX package's
``inputs/hocr.py``, which is built on lxml; the GPU machines the port
targets do not ship lxml, so the port reads hOCR with
``xml.etree.ElementTree.iterparse`` instead.  Pages stream in O(page)
memory: each ``ocr_page`` element is cleared and detached after it has
been yielded.  Unlike lxml's ``recover=True`` mode, malformed XML
raises ``xml.etree.ElementTree.ParseError``.
"""

import xml.etree.ElementTree as ET

WRITING_DIRECTION_UNSPECIFIED = 0
WRITING_DIRECTION_LEFT_TO_RIGHT = 1
WRITING_DIRECTION_RIGHT_TO_LEFT = 2

_PARA_CLASSES = ('ocr_par',)
_LINE_CLASSES = ('ocr_line', 'ocr_header', 'ocr_textfloat', 'ocr_caption')
_WORD_CLASSES = ('ocrx_word',)


def _title_props(elem):
    """Parse an hOCR ``title`` attribute into {prop: [values...]}."""
    props = {}
    for part in (elem.get('title') or '').split(';'):
        part = part.strip()
        if not part:
            continue
        fields = part.split(' ')
        props[fields[0]] = [f.strip('"') for f in fields[1:] if f]
    return props


def _ocr_class(elem):
    return (elem.get('class') or '').strip()


def hocr_page_iterator(fp_or_path):
    """Yield ocr_page elements one at a time, freeing parsed subtrees."""
    own = isinstance(fp_or_path, (str, bytes))
    source = open(fp_or_path, 'rb') if own else fp_or_path
    try:
        stack = []
        for event, elem in ET.iterparse(source, events=('start', 'end')):
            if event == 'start':
                stack.append(elem)
                continue
            stack.pop()
            if elem.tag.endswith('div') and _ocr_class(elem) == 'ocr_page':
                yield elem
                elem.clear()
                if stack:
                    stack[-1].remove(elem)
    finally:
        if own:
            source.close()


def hocr_page_get_dimensions(page):
    """(width, height) from the page bbox."""
    bbox = _title_props(page).get('bbox')
    if bbox and len(bbox) == 4:
        return int(float(bbox[2])), int(float(bbox[3]))
    return None, None


def hocr_page_get_scan_res(page):
    """(x_res, y_res) from the page ``scan_res`` property, else (None, None)."""
    res = _title_props(page).get('scan_res')
    if res and len(res) >= 2:
        try:
            return int(float(res[0])), int(float(res[1]))
        except ValueError:
            return None, None
    return None, None


def _bbox_of(elem):
    bbox = _title_props(elem).get('bbox')
    if bbox and len(bbox) == 4:
        return [float(v) for v in bbox]
    return None


def _iter_class(root, classes):
    for elem in root.iter():
        if _ocr_class(elem) in classes:
            yield elem


def _float_prop(props, key):
    try:
        return float(props[key][0])
    except (KeyError, IndexError, ValueError):
        return None


def hocr_page_to_word_data(page, scaler=1):
    """Extract [{'lines': [{'bbox', 'baseline', 'words': [...]}]}].

    Word fields: text, bbox, fontsize (x_fsize or line x_size, scaled),
    confidence (x_wconf, default 100), writing_direction (paragraph
    ``dir`` attribute)."""
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
            if len(lprops.get('baseline', ())) >= 2:
                try:
                    baseline = (float(lprops['baseline'][0]),
                                float(lprops['baseline'][1]))
                except ValueError:
                    pass
            x_size = _float_prop(lprops, 'x_size')
            words = []
            for word in _iter_class(line, _WORD_CLASSES):
                wprops = _title_props(word)
                wbbox = _bbox_of(word)
                if wbbox is None:
                    continue
                conf = _float_prop(wprops, 'x_wconf')
                fsize = 0
                if 'x_fsize' in wprops:
                    v = _float_prop(wprops, 'x_fsize')
                    if v is not None:
                        fsize = v
                elif x_size is not None:
                    fsize = x_size
                words.append({
                    'text': ''.join(word.itertext()),
                    'bbox': wbbox,
                    'fontsize': fsize * scaler,
                    'confidence': 100 if conf is None else int(conf),
                    'writing_direction': direction,
                })
            if words:
                lines.append({'bbox': bbox, 'baseline': baseline,
                              'words': words})
        if lines:
            paragraphs.append({'lines': lines})
    return paragraphs

