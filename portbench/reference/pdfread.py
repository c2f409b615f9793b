"""A small PDF reader for the judge: the classic cross-reference table,
direct objects and streams (FlateDecode or raw), enough to walk a written
book's pages, images and text.  It shares no code with the program's PDF
reader or writer."""

import re
import zlib

WS = b' \t\r\n\f\x00'
DELIM = b'()<>[]{}/%'


class Name(str):
    pass


class Ref:
    __slots__ = ('num',)

    def __init__(self, num):
        self.num = num

    def __repr__(self):
        return 'Ref(%d)' % self.num


class Stream:
    def __init__(self, d, raw):
        self.dict = d
        self.raw = raw

    def data(self):
        """The stream's bytes after its filters (FlateDecode only; image
        codecs are left to their decoders)."""
        f = self.dict.get('Filter')
        if f == 'FlateDecode':
            return zlib.decompress(self.raw)
        if f is None:
            return self.raw
        raise ValueError('filter %s not decoded here' % f)


class PdfError(ValueError):
    pass


class Lexer:
    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def skip(self):
        b = self.buf
        while self.pos < len(b):
            c = b[self.pos:self.pos + 1]
            if c in WS and c:
                self.pos += 1
            elif c == b'%':
                while self.pos < len(b) and b[self.pos] not in b'\r\n':
                    self.pos += 1
            else:
                return

    def token(self):
        self.skip()
        b = self.buf
        if self.pos >= len(b):
            raise PdfError('unexpected end')
        c = b[self.pos:self.pos + 1]
        if c in (b'[', b']', b'{', b'}'):
            self.pos += 1
            return c
        if c == b'<' and b[self.pos:self.pos + 2] == b'<<':
            self.pos += 2
            return b'<<'
        if c == b'>' and b[self.pos:self.pos + 2] == b'>>':
            self.pos += 2
            return b'>>'
        start = self.pos
        self.pos += 1
        while self.pos < len(b) and b[self.pos] not in WS \
                and b[self.pos] not in DELIM:
            self.pos += 1
        return b[start:self.pos]

    def obj(self):
        self.skip()
        b = self.buf
        c = b[self.pos:self.pos + 1]
        if c == b'(':
            return self._literal()
        if c == b'<' and b[self.pos:self.pos + 2] != b'<<':
            end = b.index(b'>', self.pos)
            hexs = re.sub(rb'\s', b'', b[self.pos + 1:end])
            self.pos = end + 1
            if len(hexs) % 2:
                hexs += b'0'
            return bytes.fromhex(hexs.decode('ascii'))
        if c == b'/':
            self.pos += 1
            start = self.pos
            while self.pos < len(b) and b[self.pos] not in WS \
                    and b[self.pos] not in DELIM:
                self.pos += 1
            raw = b[start:self.pos]
            return Name(re.sub(rb'#([0-9A-Fa-f]{2})',
                               lambda m: bytes([int(m.group(1), 16)]),
                               raw).decode('latin-1'))
        tok = self.token()
        if tok == b'<<':
            d = {}
            while True:
                self.skip()
                if b[self.pos:self.pos + 2] == b'>>':
                    self.pos += 2
                    return d
                key = self.obj()
                if not isinstance(key, Name):
                    raise PdfError('dictionary key %r' % (key,))
                d[str(key)] = self.obj()
        if tok == b'[':
            arr = []
            while True:
                self.skip()
                if b[self.pos:self.pos + 1] == b']':
                    self.pos += 1
                    return arr
                arr.append(self.obj())
        if tok == b'true':
            return True
        if tok == b'false':
            return False
        if tok == b'null':
            return None
        if re.fullmatch(rb'[+-]?\d+', tok):
            save = self.pos
            try:
                t2 = self.token()
                t3 = self.token()
            except PdfError:
                t2 = t3 = None
            if t3 == b'R' and re.fullmatch(rb'\d+', t2 or b''):
                return Ref(int(tok))
            self.pos = save
            return int(tok)
        if re.fullmatch(rb'[+-]?(\d+\.?\d*|\.\d+)', tok):
            return float(tok)
        raise PdfError('unexpected token %r' % tok)

    def _literal(self):
        b = self.buf
        self.pos += 1
        out = bytearray()
        depth = 1
        esc = {ord('n'): 10, ord('r'): 13, ord('t'): 9, ord('b'): 8,
               ord('f'): 12, ord('('): 40, ord(')'): 41, ord('\\'): 92}
        while True:
            c = b[self.pos]
            self.pos += 1
            if c == 0x5C:
                n = b[self.pos]
                self.pos += 1
                if n in esc:
                    out.append(esc[n])
                elif 0x30 <= n <= 0x37:
                    digits = bytes([n])
                    while len(digits) < 3 and 0x30 <= b[self.pos] <= 0x37:
                        digits += b[self.pos:self.pos + 1]
                        self.pos += 1
                    out.append(int(digits, 8) & 0xFF)
                elif n in (10, 13):
                    if n == 13 and b[self.pos] == 10:
                        self.pos += 1
                else:
                    out.append(n)
            elif c == 0x28:
                depth += 1
                out.append(c)
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    return bytes(out)
                out.append(c)
            else:
                out.append(c)


class Pdf:
    """A parsed file: ``offsets`` from its xref table, ``trailer``, and
    ``get(ref_or_value)`` resolving objects on demand."""

    def __init__(self, data):
        self.buf = data
        m = re.search(rb'startxref\s+(\d+)\s+%%EOF\s*$', data[-64:])
        if not m:
            raise PdfError('no startxref at the end of the file')
        pos = int(m.group(1))
        if data[pos:pos + 4] != b'xref':
            raise PdfError('startxref does not point at an xref table')
        lx = Lexer(data, pos + 4)
        self.offsets = {}
        while True:
            lx.skip()
            if data[lx.pos:lx.pos + 7] == b'trailer':
                lx.pos += 7
                break
            first, count = int(lx.token()), int(lx.token())
            for i in range(count):
                off, _gen, kind = lx.token(), lx.token(), lx.token()
                if kind == b'n':
                    self.offsets[first + i] = int(off)
        self.trailer = lx.obj()
        self._cache = {}

    def obj_at(self, num):
        if num not in self._cache:
            off = self.offsets.get(num)
            if off is None:
                raise PdfError('object %d not in the xref table' % num)
            lx = Lexer(self.buf, off)
            head = (lx.token(), lx.token(), lx.token())
            if head != (b'%d' % num, b'0', b'obj'):
                raise PdfError('xref offset of object %d points at %r'
                               % (num, head))
            value = lx.obj()
            lx.skip()
            if self.buf[lx.pos:lx.pos + 6] == b'stream':
                p = lx.pos + 6
                if self.buf[p:p + 2] == b'\r\n':
                    p += 2
                elif self.buf[p:p + 1] == b'\n':
                    p += 1
                n = self.get(value['Length'])
                raw = self.buf[p:p + n]
                if not re.match(rb'\s*endstream', self.buf[p + n:p + n + 12]):
                    raise PdfError('object %d: /Length does not end at '
                                   'endstream' % num)
                value = Stream(value, raw)
            self._cache[num] = value
        return self._cache[num]

    def get(self, v):
        while isinstance(v, Ref):
            v = self.obj_at(v.num)
        return v

    def pages(self):
        """Page dictionaries in document order."""
        out = []

        def walk(node):
            node = self.get(node)
            if node.get('Type') == 'Pages':
                for kid in self.get(node['Kids']):
                    walk(kid)
            else:
                out.append(node)
        walk(self.get(self.trailer['Root'])['Pages'])
        return out

    def content(self, page):
        c = self.get(page.get('Contents'))
        parts = c if isinstance(c, list) else [c]
        return b'\n'.join(self.get(p).data() for p in parts if p is not None)


def read(path):
    with open(path, 'rb') as fp:
        return Pdf(fp.read())
