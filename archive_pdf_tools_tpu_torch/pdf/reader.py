# Copied from archive_pdf_tools_tpu/pdf/reader.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Minimal PDF reader: xref tables/streams, objects, pages, images.

The reference delegates all PDF parsing to PyMuPDF (``fitz`` imports in
``recode.py:35``, ``mrc.py:39``, every bin/ tool).  This is our own
parser covering what the framework needs: classic xref tables, xref
streams (with PNG predictors), object streams (ObjStm), the page tree,
image XObject inventory + raw extraction, content streams, Info/XMP
metadata.  It is not a rendering engine.
"""

import re
import zlib


class PdfError(Exception):
    pass


class PName(str):
    """Parsed PDF name."""


class PRef:
    __slots__ = ('num', 'gen')

    def __init__(self, num, gen=0):
        self.num = num
        self.gen = gen

    def __repr__(self):
        return 'PRef(%d,%d)' % (self.num, self.gen)

    def __eq__(self, other):
        return isinstance(other, PRef) and \
            (self.num, self.gen) == (other.num, other.gen)

    def __hash__(self):
        return hash((self.num, self.gen))


class PStream:
    def __init__(self, d, raw, doc):
        self.dict = d
        self.raw = raw
        self._doc = doc

    def decoded(self):
        """Apply Flate/LZW/ASCIIHex/ASCII85/RL filters; pass others
        (image codecs) through raw."""
        data = self.raw
        filters = self._doc.resolve(self.dict.get('Filter'))
        if filters is None:
            return data
        if not isinstance(filters, list):
            filters = [filters]
        parms = self._doc.resolve(self.dict.get('DecodeParms'))
        if not isinstance(parms, list):
            parms = [parms] * len(filters)
        for filt, parm in zip(filters, parms):
            filt = str(filt)
            if filt == 'FlateDecode':
                data = zlib.decompress(data)
                data = _apply_predictor(data, self._doc.resolve(parm))
            elif filt == 'LZWDecode':
                pd = self._doc.resolve(parm)
                early = 1
                if isinstance(pd, dict):
                    try:
                        early = int(self._doc.resolve(
                            pd.get('EarlyChange', 1)))
                    except (TypeError, ValueError):
                        early = 1
                data = lzw_decode(data, early)
                data = _apply_predictor(data, pd)
            elif filt == 'ASCIIHexDecode':
                data = bytes.fromhex(
                    data.replace(b'>', b'').decode('ascii'))
            elif filt == 'ASCII85Decode':
                data = a85_decode(data)
            elif filt == 'RunLengthDecode':
                data = _rle_decode(data)
            else:
                break  # image codecs etc: leave raw
        return data


def _apply_predictor(data, parms):
    if not isinstance(parms, dict):
        return data
    pred = parms.get('Predictor', 1)
    if pred < 2:
        return data
    colors = parms.get('Colors', 1)
    bpc = parms.get('BitsPerComponent', 8)
    columns = parms.get('Columns', 1)
    bpp = max(1, (colors * bpc) // 8)
    stride = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(stride)
    pos = 0
    while pos < len(data):
        ft = data[pos]
        row = bytearray(data[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ft == 1:
            for i in range(bpp, stride):
                row[i] = (row[i] + row[i - bpp]) & 0xFF
        elif ft == 2:
            for i in range(stride):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:
            for i in range(stride):
                left = row[i - bpp] if i >= bpp else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[i] = (row[i] + pr) & 0xFF
        out += row
        prev = row
    return bytes(out)


def lzw_decode(data, early=1):
    """PDF /LZWDecode (ISO 32000-1 7.4.4; the TIFF/GIF variant): MSB-
    first codes of 9..12 bits, 256 = clear-table, 257 = EOD.  With
    /EarlyChange 1 (the default) the code width grows one entry before
    the table actually overflows the current width.  Old distilled and
    TeX-produced PDFs use this for content streams and fonts; the
    reference inherits support from MuPDF."""
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b'', b'']
    width = 9
    prev = None
    buf = 0
    nbits = 0
    for b in data:
        buf = (buf << 8) | b
        nbits += 8
        while nbits >= width:
            nbits -= width
            code = (buf >> nbits) & ((1 << width) - 1)
            if code == 256:
                table = table[:258]
                width = 9
                prev = None
                continue
            if code == 257:
                return bytes(out)
            if prev is None:
                if code >= len(table):
                    raise PdfError('LZW: bad first code %d' % code)
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise PdfError('LZW: code %d beyond table' % code)
            out += entry
            prev = entry
            if len(table) >= (1 << width) - early and width < 12:
                width += 1
    return bytes(out)


def a85_decode(data):
    """PDF /ASCII85Decode: whitespace-tolerant, optional '<~' prefix,
    '~>' terminator, 'z' zero-group shorthand."""
    import base64
    s = bytes(data).translate(None, b' \t\r\n\x0c\x00')
    if s.startswith(b'<~'):
        s = s[2:]
    end = s.find(b'~')
    if end >= 0:
        s = s[:end]
    return base64.a85decode(s)


def _rle_decode(data):
    out = bytearray()
    i = 0
    while i < len(data):
        n = data[i]
        if n == 128:
            break
        if n < 128:
            out += data[i + 1:i + 2 + n]
            i += 2 + n
        else:
            out += data[i + 1:i + 2] * (257 - n)
            i += 2
    return bytes(out)


_WS = b'\x00\t\n\x0c\r '
_DELIM = b'()<>[]{}/%'


class _Lexer:
    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos

    def skip_ws(self):
        d = self.data
        while self.pos < len(d):
            c = d[self.pos]
            if c in _WS:
                self.pos += 1
            elif c == 0x25:  # comment
                while self.pos < len(d) and d[self.pos] not in (10, 13):
                    self.pos += 1
            else:
                break

    def parse_object(self):
        self.skip_ws()
        d = self.data
        p = self.pos
        if p >= len(d):
            raise PdfError('eof')
        c = d[p]
        if c == 0x2F:   # /name
            return self._parse_name()
        if c == 0x28:   # (string)
            return self._parse_litstring()
        if c == 0x3C:   # << or <hex>
            if d[p + 1:p + 2] == b'<':
                return self._parse_dict()
            return self._parse_hexstring()
        if c == 0x5B:   # [
            self.pos += 1
            arr = []
            while True:
                self.skip_ws()
                if self.data[self.pos:self.pos + 1] == b']':
                    self.pos += 1
                    return arr
                arr.append(self.parse_object())
        if d.startswith(b'true', p):
            self.pos += 4
            return True
        if d.startswith(b'false', p):
            self.pos += 5
            return False
        if d.startswith(b'null', p):
            self.pos += 4
            return None
        # number or reference
        m = re.match(rb'[+-]?(\d+\.\d*|\.\d+|\d+)', d[p:p + 64])
        if not m:
            raise PdfError('bad token at %d: %r' % (p, d[p:p + 20]))
        tok = m.group(0)
        self.pos = p + len(tok)
        if b'.' in tok:
            return float(tok)
        # lookahead for "gen R"
        save = self.pos
        self.skip_ws()
        m2 = re.match(rb'(\d+)\s+R(?![a-zA-Z0-9])',
                      d[self.pos:self.pos + 32])
        if m2:
            self.pos += m2.end()
            return PRef(int(tok), int(m2.group(1)))
        self.pos = save
        return int(tok)

    def _parse_name(self):
        d = self.data
        p = self.pos + 1
        out = bytearray()
        while p < len(d):
            c = d[p]
            if c in _WS or c in _DELIM:
                break
            if c == 0x23 and p + 2 < len(d):
                out.append(int(d[p + 1:p + 3], 16))
                p += 3
            else:
                out.append(c)
                p += 1
        self.pos = p
        return PName(out.decode('latin-1'))

    def _parse_litstring(self):
        d = self.data
        p = self.pos + 1
        depth = 1
        out = bytearray()
        while p < len(d):
            c = d[p]
            if c == 0x5C:  # backslash
                nxt = d[p + 1]
                esc = {0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12,
                       0x28: 40, 0x29: 41, 0x5C: 92}
                if nxt in esc:
                    out.append(esc[nxt])
                    p += 2
                elif 0x30 <= nxt <= 0x37:
                    m = re.match(rb'[0-7]{1,3}', d[p + 1:p + 4])
                    out.append(int(m.group(0), 8) & 0xFF)
                    p += 1 + len(m.group(0))
                elif nxt in (10, 13):
                    p += 2
                    if nxt == 13 and d[p:p + 1] == b'\n':
                        p += 1
                else:
                    out.append(nxt)
                    p += 2
            elif c == 0x28:
                depth += 1
                out.append(c)
                p += 1
            elif c == 0x29:
                depth -= 1
                if depth == 0:
                    p += 1
                    break
                out.append(c)
                p += 1
            else:
                out.append(c)
                p += 1
        self.pos = p
        return bytes(out)

    def _parse_hexstring(self):
        d = self.data
        end = d.index(b'>', self.pos)
        hx = re.sub(rb'\s', b'', d[self.pos + 1:end])
        if len(hx) % 2:
            hx += b'0'
        self.pos = end + 1
        return bytes.fromhex(hx.decode('ascii'))

    def _parse_dict(self):
        self.pos += 2
        out = {}
        while True:
            self.skip_ws()
            if self.data[self.pos:self.pos + 2] == b'>>':
                self.pos += 2
                return out
            key = self.parse_object()
            val = self.parse_object()
            out[str(key)] = val


class PdfReader:
    def __init__(self, path_or_data):
        if isinstance(path_or_data, (bytes, bytearray)):
            self.data = bytes(path_or_data)
        else:
            with open(path_or_data, 'rb') as fp:
                self.data = fp.read()
        self.xref = {}          # num -> (offset, None) | ('objstm', stm, idx)
        self.trailer = {}
        self._cache = {}
        self._objstm_cache = {}
        self._crypt = None
        self._encrypt_num = None
        self._load_xref()
        self._init_crypt()
        self._pages = None

    def _init_crypt(self, password=b''):
        """Standard security handler (the reference gets this from
        PyMuPDF; see pdf/crypt.py)."""
        enc_ref = self.trailer.get('Encrypt')
        if enc_ref is None:
            return
        self._encrypt_num = enc_ref.num if isinstance(enc_ref, PRef) \
            else None
        enc = self.resolve(enc_ref)
        ids = self.trailer.get('ID')
        id0 = ids[0] if isinstance(ids, list) and ids else b''
        if not isinstance(id0, bytes):
            id0 = b''
        from .crypt import StandardDecryptor
        self._crypt = StandardDecryptor(enc, id0, password=password,
                                        resolve=self.resolve)

    def _decrypt_value(self, val, num):
        """Recursively decrypt strings (and the stream body) of a
        just-parsed top-level object."""
        c = self._crypt
        if isinstance(val, bytes):
            return c.decrypt_string(val, num)
        if isinstance(val, list):
            return [self._decrypt_value(v, num) for v in val]
        if isinstance(val, dict):
            return {k: self._decrypt_value(v, num) for k, v in val.items()}
        if isinstance(val, PStream):
            t = val.dict.get('Type')
            val.dict = self._decrypt_value(val.dict, num)
            if str(t) != 'XRef':        # xref streams are never encrypted
                val.raw = c.decrypt_stream(val.raw, num)
            return val
        return val

    # ---- xref loading ---------------------------------------------------

    def _load_xref(self):
        m = None
        for m in re.finditer(rb'startxref\s+(\d+)', self.data[-2048:]):
            pass
        if m is None:
            return self._scan_all_objects()
        pos = int(m.group(1))
        seen = set()
        while pos is not None and pos not in seen:
            seen.add(pos)
            try:
                pos = self._load_xref_section(pos)
            except (PdfError, ValueError, KeyError, zlib.error):
                return self._scan_all_objects()
        if not self.xref:
            self._scan_all_objects()

    def _load_xref_section(self, pos):
        data = self.data
        lex = _Lexer(data, pos)
        lex.skip_ws()
        if data.startswith(b'xref', lex.pos):
            lex.pos += 4
            while True:
                lex.skip_ws()
                if data.startswith(b'trailer', lex.pos):
                    lex.pos += 7
                    trailer = lex.parse_object()
                    for k, v in trailer.items():
                        self.trailer.setdefault(k, v)
                    if 'XRefStm' in trailer:
                        self._load_xref_section(trailer['XRefStm'])
                    prev = trailer.get('Prev')
                    return int(prev) if prev is not None else None
                m = re.match(rb'(\d+)\s+(\d+)', data[lex.pos:lex.pos + 64])
                if not m:
                    raise PdfError('bad xref subsection')
                start, count = int(m.group(1)), int(m.group(2))
                lex.pos += m.end()
                lex.skip_ws()
                for i in range(count):
                    entry = data[lex.pos:lex.pos + 20]
                    off = int(entry[0:10])
                    typ = entry[17:18]
                    num = start + i
                    if typ == b'n' and num not in self.xref:
                        self.xref[num] = ('file', off, None)
                    lex.pos += 20
        else:
            # xref stream
            obj, stream = self._parse_object_at(pos)
            if stream is None:
                raise PdfError('expected xref stream')
            d = stream.dict
            for k, v in d.items():
                self.trailer.setdefault(k, v)
            widths = [int(w) for w in self.resolve(d['W'])]
            size = int(self.resolve(d['Size']))
            index = self.resolve(d.get('Index', [0, size]))
            raw = stream.decoded()
            rowlen = sum(widths)
            rows = [raw[i:i + rowlen] for i in range(0, len(raw), rowlen)]
            ri = 0
            for j in range(0, len(index), 2):
                start, count = int(index[j]), int(index[j + 1])
                for num in range(start, start + count):
                    if ri >= len(rows):
                        break
                    row = rows[ri]
                    ri += 1
                    fields = []
                    p = 0
                    for wdt in widths:
                        fields.append(int.from_bytes(row[p:p + wdt], 'big')
                                      if wdt else 1)
                        p += wdt
                    ftype = fields[0]
                    if num in self.xref:
                        continue
                    if ftype == 1:
                        self.xref[num] = ('file', fields[1], None)
                    elif ftype == 2:
                        self.xref[num] = ('objstm', fields[1], fields[2])
            prev = d.get('Prev')
            return int(self.resolve(prev)) if prev is not None else None

    def _scan_all_objects(self):
        """Fallback: brute-force scan for 'N 0 obj' markers."""
        for m in re.finditer(rb'(\d+)\s+(\d+)\s+obj\b', self.data):
            self.xref[int(m.group(1))] = ('file', m.start(), None)
        t = self.data.rfind(b'trailer')
        if t >= 0:
            lex = _Lexer(self.data, t + 7)
            try:
                self.trailer.update(lex.parse_object())
            except PdfError:
                pass
        if 'Root' not in self.trailer:
            # look for a catalog
            for num in self.xref:
                try:
                    obj = self.object(num)
                except PdfError:
                    continue
                if isinstance(obj, dict) and \
                        str(obj.get('Type')) == 'Catalog':
                    self.trailer['Root'] = PRef(num)
                    break

    # ---- object access ----------------------------------------------------

    def _parse_object_at(self, offset):
        data = self.data
        m = re.match(rb'\s*(\d+)\s+(\d+)\s+obj', data[offset:offset + 64])
        if not m:
            raise PdfError('no obj at %d' % offset)
        lex = _Lexer(data, offset + m.end())
        obj = lex.parse_object()
        lex.skip_ws()
        if data.startswith(b'stream', lex.pos):
            p = lex.pos + 6
            if data[p:p + 2] == b'\r\n':
                p += 2
            elif data[p:p + 1] in (b'\n', b'\r'):
                p += 1
            length = self.resolve(obj.get('Length'))
            if not isinstance(length, int):
                end = data.index(b'endstream', p)
                length = end - p
                raw = data[p:end]
            else:
                raw = data[p:p + length]
            return obj, PStream(obj, raw, self)
        return obj, None

    def object(self, num):
        if num in self._cache:
            return self._cache[num]
        entry = self.xref.get(num)
        if entry is None:
            return None
        if entry[0] == 'file':
            obj, stream = self._parse_object_at(entry[1])
            val = stream if stream is not None else obj
            if self._crypt is not None and num != self._encrypt_num:
                val = self._decrypt_value(val, num)
        else:
            _, stm_num, idx = entry
            val = self._objstm_object(stm_num, idx)
        self._cache[num] = val
        return val

    def _objstm_object(self, stm_num, idx):
        if stm_num not in self._objstm_cache:
            stm = self.object(stm_num)
            if not isinstance(stm, PStream):
                raise PdfError('bad objstm')
            data = stm.decoded()
            n = int(self.resolve(stm.dict['N']))
            first = int(self.resolve(stm.dict['First']))
            head = _Lexer(data, 0)
            pairs = []
            for _ in range(n):
                onum = head.parse_object()
                ooff = head.parse_object()
                pairs.append((onum, ooff))
            objs = []
            for onum, ooff in pairs:
                lx = _Lexer(data, first + ooff)
                objs.append(lx.parse_object())
            self._objstm_cache[stm_num] = objs
        return self._objstm_cache[stm_num][idx]

    def resolve(self, obj):
        seen = 0
        while isinstance(obj, PRef) and seen < 64:
            obj = self.object(obj.num)
            seen += 1
        return obj

    # ---- document structure ---------------------------------------------

    @property
    def catalog(self):
        root = self.trailer.get('Root')
        cat = self.resolve(root)
        if isinstance(cat, PStream):
            cat = cat.dict
        return cat or {}

    def pages(self):
        if self._pages is None:
            self._pages = []
            self._page_refs = []
            root = self.catalog.get('Pages')
            stack = [root] if root is not None else []
            seen = set()
            while stack:
                item = stack.pop(0)
                num = item.num if isinstance(item, PRef) else None
                node = self.resolve(item)
                if node is None or id(node) in seen:
                    continue
                seen.add(id(node))
                t = str(node.get('Type', ''))
                if t == 'Pages' or 'Kids' in node:
                    kids = self.resolve(node.get('Kids')) or []
                    stack = list(kids) + stack
                else:
                    self._pages.append(node)
                    self._page_refs.append(num)
        return self._pages

    def page_object_number(self, idx):
        """Object number of page idx (None if the page tree inlined it)."""
        self.pages()
        return self._page_refs[idx]

    def page_count(self):
        return len(self.pages())

    def _inherited(self, page, key):
        node = page
        depth = 0
        while node is not None and depth < 64:
            if key in node:
                return self.resolve(node[key])
            node = self.resolve(node.get('Parent'))
            depth += 1
        return None

    def page_size(self, idx):
        box = self._inherited(self.pages()[idx], 'MediaBox') or [0, 0, 612, 792]
        box = [float(self.resolve(v)) for v in box]
        return box[2] - box[0], box[3] - box[1]

    def page_images(self, idx):
        """[(name, ref_num, image PStream)] for a page's XObject images."""
        page = self.pages()[idx]
        res = self._inherited(page, 'Resources') or {}
        xobjs = self.resolve(res.get('XObject')) or {}
        out = []
        for name, ref in xobjs.items():
            num = ref.num if isinstance(ref, PRef) else None
            obj = self.resolve(ref)
            if isinstance(obj, PStream) and \
                    str(self.resolve(obj.dict.get('Subtype'))) == 'Image':
                out.append((str(name), num, obj))
        return out

    def page_contents(self, idx):
        page = self.pages()[idx]
        contents = self.resolve(page.get('Contents'))
        if contents is None:
            return b''
        if isinstance(contents, list):
            return b'\n'.join(self.resolve(c).decoded()
                              for c in contents)
        return contents.decoded()

    def info(self):
        return self.resolve(self.trailer.get('Info')) or {}

    def xmp_metadata(self):
        md = self.resolve(self.catalog.get('Metadata'))
        if isinstance(md, PStream):
            return md.decoded()
        return None

    def extract_image(self, stream):
        """(raw bytes, filter name, width, height, colorspace name).

        Non-device colourspaces reduce to the closest device space:
        ICCBased by component count, Indexed to its base space (callers
        treating the samples as that base see the palette indices — the
        recode pipeline re-derives colour from decoded pixels), Lab and
        CalRGB to DeviceRGB, CalGray to DeviceGray."""
        d = stream.dict
        filt = self.resolve(d.get('Filter'))
        if isinstance(filt, list):
            filt = filt[-1] if filt else None
        cs = self._device_colorspace(self.resolve(d.get('ColorSpace')))
        return (stream.raw, str(filt) if filt else None,
                int(self.resolve(d.get('Width'))),
                int(self.resolve(d.get('Height'))),
                cs)

    def _device_colorspace(self, cs, depth=0):
        if cs is None or depth > 4:
            return None
        if isinstance(cs, PName) or isinstance(cs, str):
            name = str(cs)
            if name in ('CalRGB', 'Lab'):
                return 'DeviceRGB'
            if name == 'CalGray':
                return 'DeviceGray'
            return name
        if isinstance(cs, list) and cs:
            head = str(self.resolve(cs[0]))
            if head == 'ICCBased' and len(cs) > 1:
                prof = self.resolve(cs[1])
                n = 3
                if isinstance(prof, PStream):
                    n = int(self.resolve(prof.dict.get('N', 3)))
                return {1: 'DeviceGray', 3: 'DeviceRGB',
                        4: 'DeviceCMYK'}.get(n, 'DeviceRGB')
            if head == 'Indexed' and len(cs) > 1:
                return self._device_colorspace(self.resolve(cs[1]),
                                               depth + 1)
            return self._device_colorspace(head, depth + 1)
        return None
