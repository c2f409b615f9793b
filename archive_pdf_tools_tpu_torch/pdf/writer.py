# Copied from archive_pdf_tools_tpu/pdf/writer.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Low-level PDF object writer.

The reference relies on PyMuPDF for all PDF assembly plus a bespoke
byte-appending renderer for the text layer (``pdfrenderer.py:34-446``,
``pdfhacks.py:106-177``).  This module replaces both with a small typed
object model: python dicts/lists/Name/Ref/Stream values are serialized
to COS syntax, objects live in a numbered table, and ``save`` emits a
classic cross-reference table + trailer.  Streams can be deflated on
save or stored raw (pre-compressed JBIG2/JPX/JPEG/G4 image streams).
"""

import zlib


class Name(str):
    """A PDF name (serialized with a leading slash and #-escapes)."""


class Ref(int):
    """An indirect object reference by object number."""


class Raw(bytes):
    """Pre-serialized COS bytes spliced verbatim."""


class Stream:
    def __init__(self, d=None, data=b'', deflate=False):
        self.dict = dict(d or {})
        self.data = data
        self.deflate = deflate


_NAME_OK = set(
    b'ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789'
    b'-_.*')


def _ser_name(n):
    out = b'/'
    for ch in n.encode('utf-8'):
        if ch in _NAME_OK:
            out += bytes([ch])
        else:
            out += b'#%02X' % ch
    return out


def _ser_string(s):
    if isinstance(s, str):
        try:
            raw = s.encode('ascii')
            if all(32 <= c < 127 for c in raw):
                esc = raw.replace(b'\\', b'\\\\') \
                         .replace(b'(', b'\\(').replace(b')', b'\\)')
                return b'(' + esc + b')'
        except UnicodeEncodeError:
            pass
        data = b'\xfe\xff' + s.encode('utf-16-be')
        return b'<' + data.hex().upper().encode('ascii') + b'>'
    esc = s.replace(b'\\', b'\\\\').replace(b'(', b'\\(').replace(b')', b'\\)')
    return b'(' + esc + b')'


def _ser_float(x):
    if x == int(x) and abs(x) < 1e12:
        return b'%d' % int(x)
    return ('%.6f' % x).rstrip('0').rstrip('.').encode('ascii')


def serialize(obj):
    """Serialize a python value to COS bytes."""
    if isinstance(obj, Raw):
        return bytes(obj)
    if isinstance(obj, Ref):
        return b'%d 0 R' % int(obj)
    if isinstance(obj, Name):
        return _ser_name(obj)
    if isinstance(obj, bool):
        return b'true' if obj else b'false'
    if isinstance(obj, int):
        return b'%d' % obj
    if isinstance(obj, float):
        return _ser_float(obj)
    if obj is None:
        return b'null'
    if isinstance(obj, (str, bytes)):
        return _ser_string(obj)
    if isinstance(obj, dict):
        inner = b' '.join(_ser_name(k) + b' ' + serialize(v)
                          for k, v in obj.items())
        return b'<< ' + inner + b' >>'
    if isinstance(obj, (list, tuple)):
        return b'[ ' + b' '.join(serialize(v) for v in obj) + b' ]'
    raise TypeError('cannot serialize %r' % (obj,))


class PdfWriter:
    """Numbered object table with xref-table save."""

    def __init__(self, version='1.5'):
        self.version = version
        self._objects = {}       # num -> value (dict/Stream/...)
        self._next = 1
        self.trailer_extra = {}

    def reserve(self):
        num = self._next
        self._next += 1
        self._objects[num] = None
        return Ref(num)

    def set(self, ref, value):
        self._objects[int(ref)] = value
        return ref

    def add(self, value):
        return self.set(self.reserve(), value)

    def get(self, ref):
        return self._objects[int(ref)]

    def save(self, fp, root_ref, info_ref=None, doc_id=None):
        offsets = {}
        fp.write(b'%PDF-' + self.version.encode('ascii') + b'\n')
        fp.write(b'%\xe2\xe3\xcf\xd3\n')
        pos = fp.tell()

        for num in sorted(self._objects):
            value = self._objects[num]
            if value is None:
                raise ValueError('object %d reserved but never set' % num)
            offsets[num] = pos
            chunk = b'%d 0 obj\n' % num
            if isinstance(value, Stream):
                data = value.data
                d = dict(value.dict)
                if value.deflate:
                    data = zlib.compress(data)
                    d[Name('Filter')] = Name('FlateDecode')
                d[Name('Length')] = len(data)
                chunk += serialize(d) + b'\nstream\n' + data \
                    + b'\nendstream\nendobj\n'
            else:
                chunk += serialize(value) + b'\nendobj\n'
            fp.write(chunk)
            pos += len(chunk)

        xref_pos = pos
        size = max(self._objects) + 1 if self._objects else 1
        fp.write(b'xref\n0 %d\n' % size)
        fp.write(b'0000000000 65535 f \n')
        for num in range(1, size):
            if num in offsets:
                fp.write(b'%010d 00000 n \n' % offsets[num])
            else:
                fp.write(b'0000000000 65535 f \n')
        trailer = {Name('Size'): size, Name('Root'): root_ref}
        if info_ref is not None:
            trailer[Name('Info')] = info_ref
        if doc_id is not None:
            trailer[Name('ID')] = [Raw(b'<' + doc_id.hex().encode() + b'>')] * 2
        trailer.update(self.trailer_extra)
        fp.write(b'trailer\n' + serialize(trailer) + b'\n')
        fp.write(b'startxref\n%d\n%%%%EOF\n' % xref_pos)
