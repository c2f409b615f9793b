# Copied from archive_pdf_tools_tpu/pdf/rewrite.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""PDF rewriting: load a document into the writer's object model so
pages can be modified (image replacement, content-stream edits) and the
result saved — our replacement for PyMuPDF's in-place xref surgery used
by ``bin/compress-pdf-images:25-125``.
"""

import re

from .reader import PRef, PName, PStream
from .writer import PdfWriter, Name, Ref, Stream


def _convert(obj):
    """Reader value -> writer value (refs keep their numbers)."""
    if isinstance(obj, PRef):
        return Ref(obj.num)
    if isinstance(obj, PName):
        return Name(str(obj))
    if isinstance(obj, dict):
        return {Name(k): _convert(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_convert(v) for v in obj]
    return obj


class PdfRewriter:
    """Round-trips a parsed PDF into a PdfWriter for modification."""

    def __init__(self, reader):
        self.reader = reader
        self.writer = PdfWriter()
        max_num = max(reader.xref) if reader.xref else 0
        # reserve the existing object-number space
        for _ in range(max_num):
            self.writer.reserve()
        for num in reader.xref:
            obj = reader.object(num)
            if obj is None:
                continue
            if isinstance(obj, PStream):
                d = _convert(obj.dict)
                d.pop(Name('Length'), None)
                self.writer.set(Ref(num), Stream(d, obj.raw))
            else:
                self.writer.set(Ref(num), _convert(obj))
        # drop stale xref-stream objects (we emit a classic table)
        for num in list(reader.xref):
            obj = reader.object(num)
            if isinstance(obj, PStream) and \
                    str(reader.resolve(obj.dict.get('Type'))) == 'XRef':
                self.writer.set(Ref(num), {Name('Type'): Name('Null__')})

        root = reader.trailer.get('Root')
        self.root_ref = Ref(root.num) if isinstance(root, PRef) else None
        info = reader.trailer.get('Info')
        self.info_ref = Ref(info.num) if isinstance(info, PRef) else None

    def page_ref(self, idx):
        num = self.reader.page_object_number(idx)
        if num is None:
            raise KeyError('page %d has no own object number' % idx)
        return Ref(num)

    def set_object(self, ref, value):
        self.writer.set(ref, value)

    def add_object(self, value):
        return self.writer.add(value)

    def get_object(self, ref):
        return self.writer.get(ref)

    def save(self, path):
        with open(path, 'wb') as fp:
            self.writer.save(fp, self.root_ref, self.info_ref)


_IMAGE_DO_RE = re.compile(
    rb'(?:q\s+)?(?:[-\d.]+\s+){6}cm\s+/(\S+)\s+Do(?:\s+Q)?|/(\S+)\s+Do')


def strip_image_ops(content, image_names):
    """Remove `/Name Do` invocations (and their immediate q..cm..Q wrap)
    for the given XObject names from a content stream — the moral
    equivalent of ``bin/compress-pdf-images:25-34``."""
    names = {n.encode('latin-1') for n in image_names}

    def repl(m):
        name = m.group(1) or m.group(2)
        if name in names:
            return b''
        return m.group(0)

    return _IMAGE_DO_RE.sub(repl, content)


def replace_image_ops(content, mapping):
    """Substitute each `/Name Do` with a sequence of Do's for the names
    in ``mapping[name]``, preserving the surrounding q..cm..Q transform
    context — so replacements land exactly where the original image was
    drawn (the reference re-derives bboxes via get_image_bbox,
    ``bin/compress-pdf-images:50,118-125``; in-place substitution keeps
    arbitrary rotations/skews intact too)."""
    bmap = {n.encode('latin-1'): [m.encode('latin-1') for m in v]
            for n, v in mapping.items()}

    def repl(m):
        name = m.group(1) or m.group(2)
        if name in bmap:
            seq = b' '.join(b'/' + nn + b' Do' for nn in bmap[name])
            # substitute within the match via regex: the name and Do can
            # be separated by any whitespace (wrapped content streams)
            return re.sub(rb'/' + re.escape(name) + rb'\s+Do', seq,
                          m.group(0))
        return m.group(0)

    return _IMAGE_DO_RE.sub(repl, content)
