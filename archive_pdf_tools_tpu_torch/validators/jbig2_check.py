# Copied from archive_pdf_tools_tpu/validators/jbig2_check.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Independent ITU-T T.88 (JBIG2) stream validator and decoder.

Written from the specification's decoding procedures — segment syntax
(T.88 7.2-7.4), the MQ arithmetic decoder (Annex E), the arithmetic
integer decoding procedure (Annex A), generic region decoding (6.2),
symbol dictionary decoding (6.5) and text region decoding (6.4) — as a
deliberately separate implementation from native/jbig2.cpp (which was
developed alongside the encoder and could share its blind spots).  It
parses the *general* forms (any GB template, parsed AT pixel positions,
both page-association sizes, long-form referred-segment lists, all four
REFCORNERs, every combination operator) rather than only the subset the
in-tree encoder emits, and enforces the structural rules a conformant
consumer relies on:

  * segment data lengths must exactly cover the segment payloads;
  * region bounding boxes must lie inside the page;
  * a region whose external combination operator differs from the page
    default requires the page's combination-operator-override flag
    (T.88 7.4.8.5 bit 6);
  * text regions must refer to a preceding symbol dictionary;
  * standalone files need the file header and end-of-page/-file
    segments, embedded (PDF) streams must not carry them.

Replaces the missing jbig2dec/mupdf cross-check from the reference's
ecosystem (mrc.py:502-510 emits jbig2enc `-p` streams that real PDF
viewers consume).
"""

import struct

import numpy as np


class Jbig2ValidationError(ValueError):
    pass


def _fail(msg):
    raise Jbig2ValidationError(msg)


def _s8(b):
    return b - 256 if b > 127 else b


# --------------------------------------------------------------------
# MQ arithmetic decoder — T.88 Annex E (software conventions).

# (Qe, NMPS, NLPS, SWITCH) — T.88 Table E.1.
_QE = [
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]


class MQDecoder:
    """T.88 E.3: INITDEC / DECODE / BYTEIN.

    Context state is held by the caller as [index, mps] pairs so one
    decoder can serve many context sets (the spec's 'CX' argument).
    """

    def __init__(self, data):
        self.data = data
        # INITDEC (E.3.5)
        self.bp = 0
        b0 = data[0] if len(data) > 0 else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[self.bp] if self.bp < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx):
        """DECODE (E.3.2) with the MPS/LPS exchange rules."""
        icx, mps = cx
        qe, nmps, nlps, switch = _QE[icx]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = mps
                cx[0] = nmps
            else:
                d = 1 - mps
                if switch:
                    cx[1] = 1 - mps
                cx[0] = nlps
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return mps
            if self.a < qe:
                d = 1 - mps
                if switch:
                    cx[1] = 1 - mps
                cx[0] = nlps
            else:
                d = mps
                cx[0] = nmps
        # RENORMD
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


def _new_ctx_set(n):
    return [[0, 0] for _ in range(n)]


# --------------------------------------------------------------------
# Arithmetic integer decoding — T.88 Annex A.


class IntDecoder:
    """One IAx context set (512 contexts, A.2)."""

    OOB = object()

    def __init__(self):
        self.cx = _new_ctx_set(512)

    def decode(self, mq):
        prev = 1

        def bit():
            nonlocal prev
            b = mq.decode(self.cx[prev])
            prev = ((prev << 1) | b) if prev < 256 else \
                ((((prev << 1) | b) & 511) | 256)
            return b

        s = bit()
        if not bit():
            v, n = 0, 2
        elif not bit():
            v, n = 4, 4
        elif not bit():
            v, n = 20, 6
        elif not bit():
            v, n = 84, 8
        elif not bit():
            v, n = 340, 12
        else:
            v, n = 4436, 32
        val = 0
        for _ in range(n):
            val = (val << 1) | bit()
        val += v
        if s and val == 0:
            return self.OOB
        return -val if s else val


class IdDecoder:
    """IAID (A.3): SBSYMCODELEN-bit symbol-id tree."""

    def __init__(self, codelen):
        self.codelen = codelen
        self.cx = _new_ctx_set(1 << (codelen + 1))

    def decode(self, mq):
        prev = 1
        for _ in range(self.codelen):
            prev = (prev << 1) | mq.decode(self.cx[prev])
        return prev - (1 << self.codelen)


# --------------------------------------------------------------------
# Generic region decoding — T.88 6.2.5.7.

# Per-template non-AT pixel positions, raster order, from figures
# 4-7 of the spec.  'A1'..'A4' mark the slots of the adaptive pixels;
# the full ordered template (MSB first) interleaves them at the
# positions shown in the figures.
_TEMPLATES = {
    0: [('A4',), (-1, -2), (0, -2), (1, -2), ('A3',),
        ('A2',), (-2, -1), (-1, -1), (0, -1), (1, -1), (2, -1), ('A1',),
        (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
    1: [(-1, -2), (0, -2), (1, -2), (2, -2),
        (-2, -1), (-1, -1), (0, -1), (1, -1), (2, -1), ('A1',),
        (-3, 0), (-2, 0), (-1, 0)],
    2: [(-1, -2), (0, -2), (1, -2),
        (-2, -1), (-1, -1), (0, -1), (1, -1), ('A1',),
        (-2, 0), (-1, 0)],
    3: [(-3, -1), (-2, -1), (-1, -1), (0, -1), (1, -1), ('A1',),
        (-4, 0), (-3, 0), (-2, 0), (-1, 0)],
}

# LTP (typical prediction) pseudo-pixel context per template, 6.2.5.7.
_TPGDON_CTX = {0: 0x9B25, 1: 0x0795, 2: 0x00E5, 3: 0x0195}

_NOMINAL_AT = {
    0: [(3, -1), (-3, -1), (2, -2), (-2, -2)],
    1: [(3, -1)], 2: [(2, -1)], 3: [(2, -1)],
}


def _resolve_template(template, at):
    """Ordered (dx, dy) template with AT slots substituted."""
    slots = _TEMPLATES[template]
    out = []
    for s in slots:
        if isinstance(s[0], str):
            out.append(at[int(s[0][1]) - 1])
        else:
            out.append(s)
    return out


def decode_generic(mq, gb_ctx, w, h, template, at, tpgdon,
                   out=None):
    """6.2.5.7 generic region decoding into a (h, w) uint8 array.

    The above-row context contributions are vectorized per row; the
    in-row (dy == 0) pixels are carried serially, as they depend on
    just-decoded values.
    """
    tmpl = _resolve_template(template, at)
    nbits = len(tmpl)
    page = out if out is not None else np.zeros((h, w), np.uint8)
    above = [(dx, dy, nbits - 1 - i) for i, (dx, dy) in enumerate(tmpl)
             if dy < 0]
    inrow = [(dx, nbits - 1 - i) for i, (dx, dy) in enumerate(tmpl)
             if dy == 0]
    if any(dy > 0 for _, dy in tmpl) or any(dx >= 0 for dx, _ in inrow):
        _fail('template references a not-yet-decoded pixel')
    wmask = (1 << max(-dx for dx, _ in inrow)) - 1
    ltp_cx = gb_ctx[_TPGDON_CTX[template]]
    ltp = 0
    for y in range(h):
        if tpgdon:
            if mq.decode(ltp_cx):
                ltp ^= 1
            if ltp:
                if y > 0:
                    page[y] = page[y - 1]
                continue
        # vectorized contribution of all dy<0 template pixels
        acc = np.zeros(w, np.int32)
        for dx, dy, bit in above:
            yy = y + dy
            if yy < 0:
                continue
            row = page[yy]
            seg = np.zeros(w, np.int32)
            lo, hi = max(0, -dx), min(w, w - dx)
            if lo < hi:
                seg[lo:hi] = row[lo + dx:hi + dx]
            acc |= seg << bit
        accl = acc.tolist()
        rowout = page[y]
        dec = mq.decode
        # serial in-row part
        window = 0  # last decoded bits, bit k = pixel at x-1-k
        for x in range(w):
            cxv = accl[x]
            for dx, bit in inrow:
                k = -dx - 1
                cxv |= ((window >> k) & 1) << bit
            d = dec(gb_ctx[cxv])
            rowout[x] = d
            window = ((window << 1) | d) & wmask
    return page


# --------------------------------------------------------------------
# Symbol dictionary — T.88 6.5 (SDHUFF=0).


def decode_symbol_dict(data):
    if len(data) < 2:
        _fail('symbol dict: truncated flags')
    flags = (data[0] << 8) | data[1]
    sdhuff = flags & 1
    sdrefagg = (flags >> 1) & 1
    template = (flags >> 10) & 3
    rtemplate = (flags >> 12) & 1
    ctx_used = (flags >> 8) & 1
    ctx_retained = (flags >> 9) & 1
    if sdhuff:
        _fail('symbol dict: SDHUFF=1 not supported by this validator')
    if ctx_used or ctx_retained:
        _fail('symbol dict: imported/retained contexts unsupported')
    pos = 2
    nat = {0: 4, 1: 1, 2: 1, 3: 1}[template]
    at = []
    for _ in range(nat):
        at.append((_s8(data[pos]), _s8(data[pos + 1])))
        pos += 2
    if sdrefagg and not rtemplate:
        pos += 4  # refinement AT pixels
    if pos + 8 > len(data):
        _fail('symbol dict: truncated counts')
    numex, numnew = struct.unpack('>II', data[pos:pos + 8])
    pos += 8
    if numnew > 1 << 20 or numex > 1 << 20:
        _fail('symbol dict: implausible symbol counts')

    mq = MQDecoder(data[pos:])
    iadh, iadw, iaex, iaai = (IntDecoder() for _ in range(4))
    gb = _new_ctx_set(1 << 16)
    syms = []
    hcheight = 0
    while len(syms) < numnew:
        dh = iadh.decode(mq)
        if dh is IntDecoder.OOB:
            _fail('symbol dict: OOB delta height')
        hcheight += dh
        if hcheight <= 0:
            _fail('symbol dict: non-positive symbol height')
        symwidth = 0
        while True:
            dw = iadw.decode(mq)
            if dw is IntDecoder.OOB:
                break
            symwidth += dw
            if symwidth <= 0:
                _fail('symbol dict: non-positive symbol width')
            if len(syms) >= numnew:
                _fail('symbol dict: more symbols than SDNUMNEWSYMS')
            if sdrefagg:
                nrefs = iaai.decode(mq)
                if nrefs != 1:
                    _fail('symbol dict: aggregate coding unsupported')
                _fail('symbol dict: refinement coding unsupported')
            bmp = decode_generic(mq, gb, symwidth, hcheight,
                                 template, at, tpgdon=False)
            syms.append(bmp)
    # export flags (6.5.10): runs alternating not-exported/exported
    exported = []
    exflag = 0
    i = 0
    while i < len(syms):
        run = iaex.decode(mq)
        if run is IntDecoder.OOB or run < 0:
            _fail('symbol dict: bad export run')
        if exflag:
            exported.extend(syms[i:i + run])
        i += run
        exflag ^= 1
    if len(exported) != numex:
        _fail('symbol dict: SDNUMEXSYMS=%d but %d exported'
              % (numex, len(exported)))
    return exported


# --------------------------------------------------------------------
# Text region — T.88 6.4 (SBHUFF=0).


def decode_text_region(data, syms):
    if len(data) < 17 + 2 + 4:
        _fail('text region: truncated')
    rw, rh, rx, ry = struct.unpack('>IIII', data[0:16])
    extop = data[16]
    flags = (data[17] << 8) | data[18]
    sbhuff = flags & 1
    refine = (flags >> 1) & 1
    logstrips = (flags >> 2) & 3
    refcorner = (flags >> 4) & 3
    transposed = (flags >> 6) & 1
    combop = (flags >> 7) & 3
    defpixel = (flags >> 9) & 1
    dsoffset = (flags >> 10) & 0x1F
    if dsoffset > 15:
        dsoffset -= 32
    if sbhuff:
        _fail('text region: SBHUFF=1 unsupported')
    if refine:
        _fail('text region: REFINE=1 unsupported')
    sbstrips = 1 << logstrips
    ninst = struct.unpack('>I', data[19:23])[0]
    mq = MQDecoder(data[23:])
    iadt, iafs, iads, iait = (IntDecoder() for _ in range(4))
    codelen = max(1, (len(syms) - 1).bit_length()) if len(syms) > 1 else 0
    # SBSYMCODELEN = ceil(log2(SBNUMSYMS)) (0 allowed for 1 symbol)
    iaid = IdDecoder(codelen)

    region = np.full((rh, rw), defpixel, np.uint8)

    dt = iadt.decode(mq)
    if dt is IntDecoder.OOB:
        _fail('text region: OOB STRIPT')
    stript = -dt * sbstrips
    firsts = 0
    done = 0
    while done < ninst:
        dt = iadt.decode(mq)
        if dt is IntDecoder.OOB:
            _fail('text region: OOB strip DT')
        stript += dt * sbstrips
        first = True
        curs = 0
        while True:
            if first:
                dfs = iafs.decode(mq)
                if dfs is IntDecoder.OOB:
                    _fail('text region: OOB first S')
                firsts += dfs
                curs = firsts
                first = False
            else:
                ids = iads.decode(mq)
                if ids is IntDecoder.OOB:
                    break
                curs += ids + dsoffset
            curt = 0 if sbstrips == 1 else iait.decode(mq)
            ti = stript + curt
            sid = iaid.decode(mq)
            if sid < 0 or sid >= len(syms):
                _fail('text region: symbol id %d out of range' % sid)
            bmp = syms[sid]
            hh, ww = bmp.shape
            if transposed:
                # not emitted by any encoder this validator certifies;
                # refusing beats a silently wrong decode of a foreign
                # stream (6.4.5 step 3.c.ix places S along y, T along x
                # with its own refcorner adjustments)
                _fail('transposed text regions unsupported')
            x0 = curs
            y0 = ti
            if refcorner in (0, 2):       # BOTTOMLEFT / BOTTOMRIGHT
                y0 = ti - hh + 1
            _compose(region, bmp, x0, y0, combop)
            curs += ww - 1
            done += 1
            if done >= ninst:
                # spec: remaining strip data must still close with OOB,
                # but encoders typically end exactly here; accept both.
                break
    return region, (rw, rh, rx, ry), extop


def _compose(dst, bmp, x0, y0, op):
    h, w = bmp.shape
    H, W = dst.shape
    sy0, sx0 = max(0, -y0), max(0, -x0)
    dy0, dx0 = max(0, y0), max(0, x0)
    hh = min(h - sy0, H - dy0)
    ww = min(w - sx0, W - dx0)
    if hh <= 0 or ww <= 0:
        return
    src = bmp[sy0:sy0 + hh, sx0:sx0 + ww]
    tgt = dst[dy0:dy0 + hh, dx0:dx0 + ww]
    if op == 0:
        tgt |= src
    elif op == 1:
        tgt &= src
    elif op == 2:
        tgt ^= src
    elif op == 3:
        tgt[...] = 1 - (tgt ^ src)
    elif op == 4:
        tgt[...] = src
    else:
        _fail('bad combination operator %d' % op)


# --------------------------------------------------------------------
# Segment-level parsing — T.88 7.2.


def _parse_segment_header(data, pos):
    start = pos
    if pos + 11 > len(data):
        _fail('truncated segment header at %d' % pos)
    number = struct.unpack('>I', data[pos:pos + 4])[0]
    flags = data[pos + 4]
    seg_type = flags & 0x3F
    page_assoc_4 = bool(flags & 0x40)
    deferred = bool(flags & 0x80)
    pos += 5
    rts = data[pos]
    count = rts >> 5
    if count == 7:
        count = struct.unpack('>I', data[pos:pos + 4])[0] & 0x1FFFFFFF
        pos += 4 + (count + 8) // 8  # long form + retain bits
    else:
        pos += 1
    ref_size = 1 if number <= 256 else (2 if number <= 65536 else 4)
    referred = []
    for _ in range(count):
        if ref_size == 1:
            referred.append(data[pos])
        elif ref_size == 2:
            referred.append(struct.unpack('>H', data[pos:pos + 2])[0])
        else:
            referred.append(struct.unpack('>I', data[pos:pos + 4])[0])
        pos += ref_size
    if page_assoc_4:
        page = struct.unpack('>I', data[pos:pos + 4])[0]
        pos += 4
    else:
        page = data[pos]
        pos += 1
    if pos + 4 > len(data):
        _fail('truncated segment header (length) at %d' % start)
    length = struct.unpack('>I', data[pos:pos + 4])[0]
    pos += 4
    if length == 0xFFFFFFFF:
        _fail('unknown-length segments unsupported')
    return {
        'number': number, 'type': seg_type, 'deferred': deferred,
        'referred': referred, 'page': page, 'length': length,
        'data_start': pos, 'header_start': start,
    }, pos


def _parse_region_info(data):
    if len(data) < 17:
        _fail('truncated region segment info')
    w, h, x, y = struct.unpack('>IIII', data[0:16])
    extop = data[16]
    if extop > 4:
        _fail('region: reserved external combination operator %d' % extop)
    return w, h, x, y, extop


def validate_jbig2(stream, embedded=True, expect=None,
                   structure_only=False):
    """Parse, structurally validate and fully decode a JBIG2 stream.

    stream: bytes (embedded/PDF segment stream, or standalone file).
    expect: optional (h, w) uint8 array; mismatches raise.
    structure_only: skip the arithmetic decode (segment syntax, region
    bounds and operator rules are still enforced) — used by the PDF/A
    validator on full-page masks where a pure-Python decode would
    dominate the run.
    Returns the decoded page as a (h, w) uint8 array of 0/1 (zeros
    beyond the page default when structure_only).
    """
    data = bytes(stream)
    pos = 0
    if not embedded:
        if data[:8] != b'\x97JB2\r\n\x1a\n':
            _fail('missing JBIG2 file header')
        hflags = data[8]
        pos = 9
        if not (hflags & 2):  # known page count
            pos += 4
    else:
        if data[:8] == b'\x97JB2\r\n\x1a\n':
            _fail('embedded stream must not carry the file header')

    page = None
    page_info = None
    dicts = {}      # segment number -> exported symbol list
    seen_numbers = set()
    end_of_page = False
    end_of_file = False
    last_number = -1

    while pos < len(data):
        seg, dpos = _parse_segment_header(data, pos)
        body = data[dpos:dpos + seg['length']]
        if len(body) != seg['length']:
            _fail('segment %d: data length %d overruns stream'
                  % (seg['number'], seg['length']))
        pos = dpos + seg['length']
        if seg['number'] in seen_numbers:
            _fail('duplicate segment number %d' % seg['number'])
        if seg['number'] < last_number:
            _fail('segment numbers not increasing at %d' % seg['number'])
        seen_numbers.add(seg['number'])
        last_number = seg['number']
        if end_of_file:
            _fail('data after end-of-file segment')
        t = seg['type']

        if t == 48:  # page information
            if page is not None:
                _fail('multiple page information segments')
            if len(body) < 19:
                _fail('page info: truncated')
            pw, ph, _xres, _yres = struct.unpack('>IIII', body[0:16])
            pflags = body[16]
            striping = (body[17] << 8) | body[18]
            if pw == 0 or ph == 0 or pw > 1 << 20 or ph > 1 << 20:
                _fail('page info: implausible size %dx%d' % (pw, ph))
            if striping & 0x8000:
                _fail('striped pages unsupported by this validator')
            defpix = (pflags >> 2) & 1
            defop = (pflags >> 3) & 3
            override_ok = bool(pflags & 0x40)
            page = np.full((ph, pw), defpix, np.uint8)
            page_info = {'w': pw, 'h': ph, 'defop': defop,
                         'override': override_ok,
                         'lossless': bool(pflags & 1)}

        elif t == 0:  # symbol dictionary
            if structure_only:
                dicts[seg['number']] = [np.zeros((1, 1), np.uint8)]
            else:
                dicts[seg['number']] = decode_symbol_dict(body)

        elif t in (4, 6, 7):  # text region (intermediate/immediate/+lossless)
            if page is None:
                _fail('text region before page info')
            syms = []
            for r in seg['referred']:
                if r in dicts:
                    syms.extend(dicts[r])
            if not syms:
                _fail('text region: no referred symbol dictionary')
            if t == 4:
                _fail('intermediate text regions unsupported')
            if structure_only:
                rw, rh, rx, ry, extop = _parse_region_info(body)
                _check_region_fits(page_info, rw, rh, rx, ry)
                _check_op(page_info, extop)
            else:
                region, (rw, rh, rx, ry), extop = \
                    decode_text_region(body, syms)
                _check_region_fits(page_info, rw, rh, rx, ry)
                _check_op(page_info, extop)
                _compose(page, region, rx, ry, extop)

        elif t in (36, 38, 39):  # generic region
            if page is None:
                _fail('generic region before page info')
            rw, rh, rx, ry, extop = _parse_region_info(body)
            _check_region_fits(page_info, rw, rh, rx, ry)
            _check_op(page_info, extop)
            gflags = body[17]
            mmr = gflags & 1
            template = (gflags >> 1) & 3
            tpgdon = bool(gflags & 8)
            if mmr:
                _fail('MMR-coded generic regions unsupported')
            p = 18
            at = []
            for _ in range({0: 4, 1: 1, 2: 1, 3: 1}[template]):
                at.append((_s8(body[p]), _s8(body[p + 1])))
                p += 2
            if t == 36:
                _fail('intermediate generic regions unsupported')
            if not structure_only:
                mq = MQDecoder(body[p:])
                gb = _new_ctx_set(1 << 16)
                region = decode_generic(mq, gb, rw, rh, template, at,
                                        tpgdon)
                _compose(page, region, rx, ry, extop)

        elif t == 49:  # end of page
            if embedded:
                _fail('end-of-page segment in embedded stream')
            end_of_page = True
        elif t == 51:  # end of file
            if embedded:
                _fail('end-of-file segment in embedded stream')
            end_of_file = True
        elif t == 50:  # end of stripe
            _fail('striped pages unsupported by this validator')
        elif t in (52, 53, 62):  # profiles, tables, extension
            pass
        else:
            _fail('unsupported segment type %d' % t)

    if page is None:
        _fail('no page information segment')
    if not embedded:
        if not end_of_page:
            _fail('standalone file missing end-of-page segment')
        if not end_of_file:
            _fail('standalone file missing end-of-file segment')

    if expect is not None and not structure_only:
        exp = (np.asarray(expect) != 0).astype(np.uint8)
        if exp.shape != page.shape:
            _fail('decoded page %s != expected %s'
                  % (page.shape, exp.shape))
        ndiff = int((exp != page).sum())
        if ndiff:
            _fail('decoded page differs from expected in %d px' % ndiff)
    return page


def _check_region_fits(page_info, rw, rh, rx, ry):
    if rx + rw > page_info['w'] or ry + rh > page_info['h']:
        _fail('region %dx%d@(%d,%d) exceeds page %dx%d'
              % (rw, rh, rx, ry, page_info['w'], page_info['h']))


def _check_op(page_info, extop):
    if extop != page_info['defop'] and not page_info['override']:
        _fail('region combination operator %d differs from page default '
              '%d without the override flag (T.88 7.4.8.5)'
              % (extop, page_info['defop']))
