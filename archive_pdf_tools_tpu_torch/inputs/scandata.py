# Copied from archive_pdf_tools_tpu/inputs/scandata.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: lxml is the port's utils/etree_compat.py.
"""IA scandata.xml parsing (lxml-based).

Replaces the xmltodict-based helpers of the reference
(``scandata.py:23-150``): skip pages, page numbers, per-page / document
DPI, and table of contents, with identical output shapes.  One parse per
call, matching the reference's (admittedly wasteful) behavior so callers
stay drop-in compatible; ``Scandata`` offers a parse-once object API.
"""

from ..utils import etree_compat as etree


def _parse(xml_file):
    tree = etree.parse(xml_file)
    root = tree.getroot()
    # strip namespace handling: use local-name lookups
    return root


def _findall_local(root, path_locals):
    """Find elements by local names regardless of namespaces."""
    cur = [root]
    for name in path_locals:
        nxt = []
        for el in cur:
            for child in el:
                if isinstance(child.tag, str) and \
                        etree.QName(child).localname == name:
                    nxt.append(child)
        cur = nxt
    return cur


def _child_text(el, local):
    for child in el:
        if isinstance(child.tag, str) and \
                etree.QName(child).localname == local:
            return child.text
    return None


class Scandata:
    """Parse-once accessor for the per-call helpers below."""

    def __init__(self, xml_file):
        root = _parse(xml_file)
        self._pages = _findall_local(root, ['pageData', 'page'])
        self._book = _findall_local(root, ['bookData'])

    def skip_pages(self):
        """Indices of pages with addToAccessFormats == false
        (``scandata.py:23-36``)."""
        skip = []
        for idx, page in enumerate(self._pages):
            if _child_text(page, 'addToAccessFormats') == 'false':
                skip.append(idx)
        return skip

    def page_numbers(self):
        """pageNumber per accessible page (None when missing)
        (``scandata.py:39-60``)."""
        res = []
        for page in self._pages:
            if _child_text(page, 'addToAccessFormats') == 'false':
                continue
            res.append(_child_text(page, 'pageNumber'))
        return res

    def dpi_per_page(self):
        """ppi per accessible page (``scandata.py:63-84``)."""
        res = []
        for page in self._pages:
            if _child_text(page, 'addToAccessFormats') == 'false':
                continue
            res.append(_child_text(page, 'ppi'))
        return res

    def document_dpi(self):
        """Book-level dpi (``scandata.py:87-98``)."""
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
        """Table of contents from pageType title attributes
        (``scandata.py:101-150``)."""
        toc = []
        accessible_count = 0
        for page in self._pages:
            leaf_num = page.get('leafNum')
            for child in page:
                if isinstance(child.tag, str) and \
                        etree.QName(child).localname == 'pageType':
                    title = child.get('title')
                    if title is not None:
                        level = int(child.get('level', 1))
                        label = child.get('label', None)
                        toc.append({'title': title, 'level': level,
                                    'label': label, 'leaf': leaf_num,
                                    'accessible-page': accessible_count})
            if _child_text(page, 'addToAccessFormats') != 'false':
                accessible_count += 1
        return toc


def scandata_xml_get_skip_pages(xml_file):
    return Scandata(xml_file).skip_pages()


def scandata_xml_get_page_numbers(xml_file):
    return Scandata(xml_file).page_numbers()


def scandata_xml_get_dpi_per_page(xml_file):
    return Scandata(xml_file).dpi_per_page()


def scandata_xml_get_document_dpi(xml_file):
    return Scandata(xml_file).document_dpi()


def scandata_xml_get_toc(xml_file):
    return Scandata(xml_file).toc()
