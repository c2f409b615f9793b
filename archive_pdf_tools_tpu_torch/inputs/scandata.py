"""IA scandata.xml reader on the standard library's ElementTree.

Same class, functions and output shapes as the JAX package's
``inputs/scandata.py``, which is built on lxml; the GPU machines the port
targets do not ship lxml.  Elements are matched by local name, whatever
their namespace, as ``inputs/hocr.py`` matches them.
"""

import xml.etree.ElementTree as ET


def _local(tag):
    return tag.rsplit('}', 1)[-1] if isinstance(tag, str) else None


def _findall_local(root, path_locals):
    """Find elements by local names regardless of namespaces."""
    cur = [root]
    for name in path_locals:
        cur = [child for el in cur for child in el
               if _local(child.tag) == name]
    return cur


def _child_text(el, local):
    for child in el:
        if _local(child.tag) == local:
            return child.text
    return None


class Scandata:
    """Parse-once accessor for the per-call helpers below."""

    def __init__(self, xml_file):
        root = ET.parse(xml_file).getroot()
        self._pages = _findall_local(root, ['pageData', 'page'])
        self._book = _findall_local(root, ['bookData'])

    def skip_pages(self):
        """Indices of pages with addToAccessFormats == false."""
        return [idx for idx, page in enumerate(self._pages)
                if _child_text(page, 'addToAccessFormats') == 'false']

    def _accessible(self):
        return [page for page in self._pages
                if _child_text(page, 'addToAccessFormats') != 'false']

    def page_numbers(self):
        """pageNumber per accessible page (None when missing)."""
        return [_child_text(page, 'pageNumber')
                for page in self._accessible()]

    def dpi_per_page(self):
        """ppi per accessible page."""
        return [_child_text(page, 'ppi') for page in self._accessible()]

    def document_dpi(self):
        """Book-level dpi."""
        if not self._book:
            return None
        val = _child_text(self._book[0], 'dpi')
        if val is None:
            return None
        try:
            return int(val)
        except ValueError:
            return None

    def toc(self):
        """Table of contents from pageType title attributes."""
        toc = []
        accessible_count = 0
        for page in self._pages:
            leaf_num = page.get('leafNum')
            for child in page:
                if _local(child.tag) != 'pageType':
                    continue
                title = child.get('title')
                if title is not None:
                    toc.append({'title': title,
                                'level': int(child.get('level', 1)),
                                'label': child.get('label', None),
                                'leaf': leaf_num,
                                'accessible-page': accessible_count})
            if _child_text(page, 'addToAccessFormats') != 'false':
                accessible_count += 1
        return toc
