# Frozen copy of tests/fixtures.py's words_to_hocr_page and HOCR_TEMPLATE,
# verbatim below this header (the template's long meta line too), so that
# a change to the test fixtures never changes the benchmark's hOCR.
"""hOCR writer for the benchmark's books: one ``ocr_page`` a page, one
``ocr_line`` for the words that share a top edge, each word an
``ocrx_word`` with confidence 95."""


def words_to_hocr_page(words, w, h, page_no=0, dpi=None):
    lines = {}
    for (x1, y1, x2, y2, text) in words:
        lines.setdefault(y1, []).append((x1, y1, x2, y2, text))
    parts = []
    scan_res = '; scan_res %d %d' % (dpi, dpi) if dpi else ''
    parts.append('<div class="ocr_page" id="page_%d" title="image x; '
                 'bbox 0 0 %d %d; ppageno %d%s">' % (page_no, w, h,
                                                     page_no, scan_res))
    parts.append('<div class="ocr_carea" title="bbox 0 0 %d %d">' % (w, h))
    parts.append('<p class="ocr_par" dir="ltr" title="bbox 0 0 %d %d">'
                 % (w, h))
    for y in sorted(lines):
        ws = lines[y]
        lx1 = min(t[0] for t in ws)
        ly1 = min(t[1] for t in ws)
        lx2 = max(t[2] for t in ws)
        ly2 = max(t[3] for t in ws)
        parts.append('<span class="ocr_line" title="bbox %d %d %d %d; '
                     'baseline 0 0; x_size %d; x_descenders 3; '
                     'x_ascenders 5">' % (lx1, ly1, lx2, ly2, ly2 - ly1))
        for (x1, y1, x2, y2, text) in ws:
            parts.append('<span class="ocrx_word" title="bbox %d %d %d %d; '
                         'x_wconf 95">%s</span> ' % (x1, y1, x2, y2, text))
        parts.append('</span>')
    parts.append('</p></div></div>')
    return '\n'.join(parts)


HOCR_TEMPLATE = '''<?xml version="1.0" encoding="UTF-8"?>
<!DOCTYPE html PUBLIC "-//W3C//DTD XHTML 1.0 Transitional//EN"
 "http://www.w3.org/TR/xhtml1/DTD/xhtml1-transitional.dtd">
<html xmlns="http://www.w3.org/1999/xhtml">
<head><title></title>
<meta name="ocr-system" content="tesseract 5" />
<meta name="ocr-capabilities" content="ocr_page ocr_carea ocr_par ocr_line ocrx_word" />
</head>
<body>
%s
</body>
</html>
'''
