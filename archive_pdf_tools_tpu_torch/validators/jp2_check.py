# Copied from archive_pdf_tools_tpu/validators/jp2_check.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Independent ITU-T T.800 / ISO 15444-1 (JPEG 2000) stream validator.

From-spec structural checker for the `.jp2` files the in-tree encoder
(codecs/jp2tpu.py) emits — the counterpart of running `opj_decompress`
in strict mode, which this environment lacks.  Checks, independently of
the encoder's code:

  boxes       JP2 signature/ftyp/jp2h(ihdr, colr)/jp2c structure, box
              lengths exact, ihdr consistent with SIZ, colr enumerated
              colourspace matching the component count
  markers     SOC/SIZ/COD/QCD/SOT/SOD/EOC ordering, marker segment
              lengths, SIZ geometry and Ssiz, COD progression/code-block
              sizes/transform, QCD scalar-expounded subband count
  packets     a full Tier-2 packet-header decode: tag-tree decoding of
              inclusion and zero-bitplane trees, the number-of-passes
              codeword, Lblock length coding, 0xFF bit-unstuffing — and
              exact length accounting: walking every packet header+body
              must land exactly on EOC, with Psot matching
  sanity      zero bitplanes <= Mb (guard + eps - 1) for every included
              block, coding passes consistent with the plane count

The pixel path (Tier-1 MQ data) is cross-checked separately by decoding
with Pillow's OpenJPEG (tests/test_jp2tpu.py); this module is about the
syntax a strict third-party decoder enforces before it ever reaches the
MQ data.
"""

import math
import struct


class Jp2ValidationError(ValueError):
    pass


def _fail(msg):
    raise Jp2ValidationError(msg)


# --------------------------------------------------------------------
# Packet-header bit reader with 0xFF unstuffing (T.800 B.10.1).


class _BitReader:
    def __init__(self, data, pos=0):
        self.data = data
        self.pos = pos
        self.cur = 0
        self.avail = 0
        self.prev_byte = None

    def bit(self):
        if self.avail == 0:
            if self.pos >= len(self.data):
                _fail('packet header overruns data')
            b = self.data[self.pos]
            self.pos += 1
            if self.prev_byte == 0xFF:
                if b & 0x80:
                    _fail('byte after 0xFF has MSB set (bad stuffing)')
                self.avail = 7
            else:
                self.avail = 8
            self.cur = b
            self.prev_byte = b
        self.avail -= 1
        return (self.cur >> self.avail) & 1

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """End of packet header: if the last consumed byte is 0xFF the
        encoder appends a 0 pad byte (a header cannot end on FF)."""
        self.avail = 0
        if self.prev_byte == 0xFF:
            if self.pos >= len(self.data):
                _fail('missing pad byte after trailing 0xFF')
            if self.data[self.pos] != 0x00:
                _fail('pad byte after trailing 0xFF is not 0x00')
            self.pos += 1
        self.prev_byte = None


class _TagTreeDec:
    """Tag-tree decoder (T.800 B.10.2)."""

    def __init__(self, w, h):
        self.levels = [(w, h)]
        while w > 1 or h > 1:
            w = (w + 1) // 2
            h = (h + 1) // 2
            self.levels.append((w, h))
        self.low = [dict() for _ in self.levels]
        self.value = [dict() for _ in self.levels]

    def decode(self, br, x, y, threshold):
        """Advance knowledge about leaf (x, y) up to ``threshold``.
        Returns (known, value)."""
        path = []
        lx, ly = x, y
        for li in range(len(self.levels)):
            path.append((li, lx, ly))
            lx //= 2
            ly //= 2
        low = 0
        known = False
        value = None
        for (li, lx, ly) in reversed(path):
            key = (lx, ly)
            nlow = self.low[li].get(key, 0)
            if low > nlow:
                nlow = low
            else:
                low = nlow
            kn = key in self.value[li]
            while low < threshold and not kn:
                if br.bit():
                    self.value[li][key] = low
                    kn = True
                else:
                    low += 1
            self.low[li][key] = low
            if kn:
                v = self.value[li][key]
                low = max(low, v)
            else:
                # undetermined at this level: leaf can't be resolved
                return (False, None)
        leaf_key = (x, y)
        li = 0
        if leaf_key in self.value[li]:
            return (True, self.value[li][leaf_key])
        return (False, None)


def _decode_npasses(br):
    """Inverse of the number-of-coding-passes codeword (B.10.6)."""
    if not br.bit():
        return 1
    if not br.bit():
        return 2
    v = br.bits(2)
    if v != 3:
        return 3 + v
    v = br.bits(5)
    if v != 31:
        return 6 + v
    return 37 + br.bits(7)


# --------------------------------------------------------------------
# Geometry helpers (must match T.800 subband size rules, written from
# the size conventions — low = ceil(n/2) at origin 0).


def _band_dims(w, h, levels):
    """Per-resolution band dims: res 0 -> [LL]; res r>=1 -> [HL,LH,HH]."""
    lws, lhs = [w], [h]
    for _ in range(levels):
        lws.append((lws[-1] + 1) // 2)
        lhs.append((lhs[-1] + 1) // 2)
    out = [[(lws[levels], lhs[levels])]]
    for r in range(1, levels + 1):
        lvl = levels - r + 1
        pw, ph = lws[lvl - 1], lhs[lvl - 1]
        lw, lh = lws[lvl], lhs[lvl]
        out.append([(pw - lw, lh), (lw, ph - lh), (pw - lw, ph - lh)])
    return out


# --------------------------------------------------------------------


def _parse_boxes(data):
    boxes = []
    pos = 0
    while pos < len(data):
        if pos + 8 > len(data):
            _fail('truncated box header at %d' % pos)
        lbox, tbox = struct.unpack('>I4s', data[pos:pos + 8])
        hdr = 8
        if lbox == 1:
            lbox = struct.unpack('>Q', data[pos + 8:pos + 16])[0]
            hdr = 16
        if lbox == 0:
            lbox = len(data) - pos
        if lbox < hdr or pos + lbox > len(data):
            _fail('box %r length %d overruns file' % (tbox, lbox))
        boxes.append((tbox, data[pos + hdr:pos + lbox]))
        pos += lbox
    return boxes


def validate_jp2(stream, strict_profile=True, collect_blocks=None):
    """Validate a .jp2 file (or raw codestream).  Returns summary facts.

    strict_profile=True asserts the exact profile codecs/jp2tpu.py
    emits (single layer, scalar-expounded QCD, default precincts) and
    walks every packet header; False accepts any Part-1 profile and
    checks boxes/markers only — used on third-party (Pillow/OpenJPEG)
    streams embedded in PDFs.

    collect_blocks: optional list; when given (strict profile only),
    every included code block's record is appended as a dict with the
    body bytes, clipped dims, nbps, npasses and orientation — the
    input of the from-spec Tier-1 decoder (jp2t1_check.decode_block),
    so tests can T1-decode a whole codestream's blocks."""
    data = bytes(stream)
    if data[:2] == b'\xff\x4f':
        return _validate_codestream(data, strict_profile,
                                    collect_blocks=collect_blocks)

    boxes = _parse_boxes(data)
    kinds = [b[0] for b in boxes]
    if not boxes or kinds[0] != b'jP  ':
        _fail('first box is not the JP2 signature box')
    if boxes[0][1] != b'\x0d\x0a\x87\x0a':
        _fail('bad JP2 signature box content')
    if len(kinds) < 2 or kinds[1] != b'ftyp':
        _fail('second box is not ftyp')
    ftyp = boxes[1][1]
    if ftyp[:4] != b'jp2 ':
        _fail('ftyp brand %r != jp2' % ftyp[:4])
    if b'jp2h' not in kinds or b'jp2c' not in kinds:
        _fail('missing jp2h or jp2c box')
    if kinds.index(b'jp2h') > kinds.index(b'jp2c'):
        _fail('jp2h must precede jp2c')

    hdr_boxes = _parse_boxes(boxes[kinds.index(b'jp2h')][1])
    hkinds = [b[0] for b in hdr_boxes]
    if not hdr_boxes or hkinds[0] != b'ihdr':
        _fail('jp2h does not start with ihdr')
    ihdr = hdr_boxes[0][1]
    if len(ihdr) != 14:
        _fail('ihdr must be 14 bytes')
    ih, iw, nc, bpc, ctyp, unkc, ipr = struct.unpack('>IIHBBBB', ihdr)
    if ctyp != 7:
        _fail('ihdr compression type %d != 7' % ctyp)
    if b'colr' not in hkinds:
        _fail('jp2h missing colr box')
    colr = hdr_boxes[hkinds.index(b'colr')][1]
    meth = colr[0]
    if meth == 1:
        enumcs = struct.unpack('>I', colr[3:7])[0]
        if nc == 1 and enumcs != 17:
            _fail('gray image with EnumCS %d (want 17)' % enumcs)
        if nc == 3 and enumcs != 16:
            _fail('RGB image with EnumCS %d (want 16 sRGB)' % enumcs)
    elif meth != 2:
        _fail('colr meth %d unsupported' % meth)

    facts = _validate_codestream(boxes[kinds.index(b'jp2c')][1],
                                 strict_profile,
                                 collect_blocks=collect_blocks)
    if (facts['w'], facts['h'], facts['ncomp']) != (iw, ih, nc):
        _fail('ihdr %dx%dx%d inconsistent with SIZ %dx%dx%d'
              % (iw, ih, nc, facts['w'], facts['h'], facts['ncomp']))
    if bpc != facts['ssiz']:
        _fail('ihdr bpc %d != SIZ Ssiz %d' % (bpc, facts['ssiz']))
    return facts


def _validate_codestream(cs, strict_profile=True,
                         collect_blocks=None):
    pos = 0
    if cs[pos:pos + 2] != b'\xff\x4f':
        _fail('missing SOC')
    pos += 2
    if cs[pos:pos + 2] != b'\xff\x51':
        _fail('SIZ must immediately follow SOC')

    siz = cod = qcd = None
    # ---- main header markers ----
    while True:
        marker = cs[pos:pos + 2]
        if marker == b'\xff\x90':       # SOT: main header done
            break
        if len(marker) < 2 or marker[0] != 0xFF:
            _fail('bad marker at %d' % pos)
        ln = struct.unpack('>H', cs[pos + 2:pos + 4])[0]
        seg = cs[pos + 4:pos + 2 + ln]
        if len(seg) != ln - 2:
            _fail('marker %s length overruns' % marker.hex())
        if marker == b'\xff\x51':
            siz = seg
        elif marker == b'\xff\x52':
            cod = seg
        elif marker == b'\xff\x5c':
            qcd = seg
        elif marker in (b'\xff\x53', b'\xff\x5d', b'\xff\x5e',
                        b'\xff\x5f', b'\xff\x55', b'\xff\x58',
                        b'\xff\x60', b'\xff\x61', b'\xff\x63',
                        b'\xff\x64'):
            pass                        # COC/QCC/RGN/TLM/PLM/CRG/COM...
        else:
            _fail('unexpected marker %s in main header' % marker.hex())
        pos += 2 + ln

    if siz is None or cod is None or qcd is None:
        _fail('main header missing SIZ/COD/QCD')

    # ---- SIZ ----
    rsiz, xsiz, ysiz, xo, yo, xt, yt, xto, yto, ncomp = \
        struct.unpack('>HIIIIIIIIH', siz[:36])
    if xsiz <= xo or ysiz <= yo:
        _fail('SIZ: empty image region')
    if xt != xsiz or yt != ysiz or xto or yto or xo or yo:
        _fail('SIZ: multi-tile or offset geometry unexpected here')
    if len(siz) != 36 + 3 * ncomp:
        _fail('SIZ length inconsistent with Csiz')
    ssiz = None
    for c in range(ncomp):
        s, xr, yr = struct.unpack('>BBB', siz[36 + 3 * c:39 + 3 * c])
        if ssiz is None:
            ssiz = s
        if s & 0x80:
            _fail('signed components unexpected')
        if xr != 1 or yr != 1:
            _fail('subsampled components unexpected')
    w, h = xsiz - xo, ysiz - yo

    # ---- COD ----
    scod, prog, layers, mct, levels, cbw, cbh, cbstyle, transform = \
        struct.unpack('>BBHBBBBBB', cod[:10])
    if prog > 4:
        _fail('bad progression order %d' % prog)
    # the packet walk assumes: one layer, one precinct per resolution
    # (Scod bit 0 clear), no SOP/EPH markers (bits 1-2 clear), and a
    # resolution-major packet order — true for LRCP/RLCP/RPCL with a
    # single layer and precinct, NOT for PCRL/CPRL (component-major)
    walkable = (scod == 0 and layers == 1 and prog <= 2)
    if not walkable:
        if not strict_profile:
            # foreign profile: box/marker checks only
            return {'w': w, 'h': h, 'ncomp': ncomp, 'ssiz': ssiz,
                    'levels': levels, 'guard': None,
                    'transform': transform, 'blocks': None,
                    'included': None, 'progression': prog, 'mct': mct,
                    'packet_walk': False}
        if scod:
            _fail('precincts/SOP/EPH unexpected (Scod=%#x)' % scod)
        if layers != 1:
            _fail('expected single-layer codestream, got %d' % layers)
        _fail('component-major progression %d not walkable' % prog)
    if mct not in (0, 1):
        _fail('bad MCT flag')
    if mct == 1 and ncomp < 3:
        _fail('MCT with fewer than 3 components')
    if not 1 <= levels <= 32:
        _fail('bad decomposition levels %d' % levels)
    cb_w, cb_h = 1 << (cbw + 2), 1 << (cbh + 2)
    if cbw > 8 or cbh > 8 or cbw + cbh > 8:
        _fail('code-block size exceeds 4096 samples')
    if transform not in (0, 1):
        _fail('bad transform %d' % transform)

    # ---- QCD ----
    sqcd = qcd[0]
    guard = sqcd >> 5
    style = sqcd & 0x1F
    nbands = 3 * levels + 1
    if style == 0x02:
        # scalar expounded (the in-tree encoder): u16 per band
        if len(qcd) != 1 + 2 * nbands:
            _fail('QCD carries %d bands, expected %d'
                  % ((len(qcd) - 1) // 2, nbands))
        eps_mu = []
        for i in range(nbands):
            v = struct.unpack('>H', qcd[1 + 2 * i:3 + 2 * i])[0]
            eps_mu.append((v >> 11, v & 0x7FF))
    elif style == 0x00:
        # 'no quantization' (reversible 5/3, what Pillow/OpenJPEG emit
        # by default): one u8 exponent per band — the packet walk is
        # transform-independent, so strict-walk these too
        if len(qcd) != 1 + nbands:
            _fail('QCD (style 0) carries %d bands, expected %d'
                  % (len(qcd) - 1, nbands))
        eps_mu = [(qcd[1 + i] >> 3, 0) for i in range(nbands)]
    else:
        if not strict_profile and style == 0x01:
            return {'w': w, 'h': h, 'ncomp': ncomp, 'ssiz': ssiz,
                    'levels': levels, 'guard': guard,
                    'transform': transform, 'blocks': None,
                    'included': None, 'progression': prog, 'mct': mct,
                    'packet_walk': False}
        _fail('unsupported quantization style, Sqcd=%#x' % sqcd)

    # ---- tile part ----
    try:
        return _walk_tile(cs, pos, w, h, ncomp, ssiz, levels, guard,
                          transform, prog, mct, cb_w, cb_h, eps_mu,
                          collect_blocks=collect_blocks)
    except Jp2ValidationError:
        if strict_profile:
            raise
        # lenient mode: a legal foreign stream may use multiple
        # tile-parts or other constructs the walk does not model —
        # accept on box/marker-level checks alone
        if b'\xff\xd9' not in cs[-4:]:
            _fail('missing EOC')
        return {'w': w, 'h': h, 'ncomp': ncomp, 'ssiz': ssiz,
                'levels': levels, 'guard': guard,
                'transform': transform, 'blocks': None,
                'included': None, 'progression': prog, 'mct': mct,
                'packet_walk': False}


def _walk_tile(cs, pos, w, h, ncomp, ssiz, levels, guard, transform,
               prog, mct, cb_w, cb_h, eps_mu, collect_blocks=None):
    if cs[pos:pos + 2] != b'\xff\x90':
        _fail('missing SOT')
    lsot, isot, psot, tpsot, tnsot = struct.unpack('>HHIBB',
                                                   cs[pos + 2:pos + 12])
    if lsot != 10:
        _fail('bad Lsot')
    if isot != 0 or tpsot != 0:
        _fail('unexpected tile/tile-part index')
    sot_start = pos
    pos += 12
    if cs[pos:pos + 2] != b'\xff\x93':
        _fail('missing SOD')
    pos += 2

    # packet walk: progression must visit each (res, comp) once per
    # layer; for LRCP with 1 layer that is res-major then comp
    band_dims = _band_dims(w, h, levels)
    mb = {}
    for r, dims in enumerate(band_dims):
        for bi in range(len(dims)):
            band_index = 0 if r == 0 else 1 + 3 * (r - 1) + bi
            eps, _mu = eps_mu[band_index]
            mb[(r, bi)] = guard + eps - 1

    total_blocks = 0
    included_blocks = 0
    for r in range(levels + 1):
        for c in range(ncomp):
            dims = band_dims[r]
            nblocks = [(-(-bw // cb_w) * -(-bh // cb_h))
                       if bw and bh else 0 for (bw, bh) in dims]
            if sum(nblocks) == 0:
                continue            # no packet emitted at all
            br = _BitReader(cs, pos)
            body_lens = []
            pending = []        # parallels body_lens: per-block facts
            if not br.bit():
                br.align()
                pos = br.pos
                continue            # empty packet
            for bi, (bw_, bh_) in enumerate(dims):
                if not (bw_ and bh_):
                    continue
                nx, ny = -(-bw_ // cb_w), -(-bh_ // cb_h)
                incl = _TagTreeDec(nx, ny)
                zbt = _TagTreeDec(nx, ny)
                lblock = {}
                for i in range(nx * ny):
                    x, y = i % nx, i // nx
                    total_blocks += 1
                    known, val = incl.decode(br, x, y, 1)
                    if not (known and val == 0):
                        continue
                    included_blocks += 1
                    # zero bitplanes: raise threshold until resolved
                    t = 1
                    while True:
                        known, zbp = zbt.decode(br, x, y, t)
                        if known:
                            break
                        t += 1
                        if t > 64:
                            _fail('runaway zero-bitplane tree')
                    if zbp > mb[(r, bi)]:
                        _fail('zero bitplanes %d > Mb %d (desync: '
                              'decoder would see negative planes)'
                              % (zbp, mb[(r, bi)]))
                    npasses = _decode_npasses(br)
                    maxpasses = 3 * (mb[(r, bi)] - zbp) - 2
                    if npasses > max(1, maxpasses):
                        _fail('npasses %d exceeds %d coded planes'
                              % (npasses, mb[(r, bi)] - zbp))
                    lb = lblock.get(i, 3)
                    while br.bit():
                        lb += 1
                    lblock[i] = lb
                    nlen = lb + int(math.floor(math.log2(npasses)))
                    body_lens.append(br.bits(nlen))
                    if collect_blocks is not None:
                        pending.append({
                            'comp': c, 'res': r, 'band': bi,
                            'bx': x, 'by': y,
                            'w': min(cb_w, bw_ - x * cb_w),
                            'h': min(cb_h, bh_ - y * cb_h),
                            'nbps': mb[(r, bi)] - zbp,
                            'npasses': npasses,
                            # encoder orient codes: 0 = LL/LH, 1 = HL,
                            # 2 = HH (codestream band order HL,LH,HH)
                            'orient': 0 if r == 0 else (1, 0, 2)[bi],
                        })
            br.align()
            pos = br.pos
            for rec, ln in zip(pending, body_lens):
                rec['data'] = cs[pos:pos + ln]
                collect_blocks.append(rec)
                pos += ln
            if collect_blocks is None:
                for ln in body_lens:
                    pos += ln
            if pos > len(cs):
                _fail('packet bodies overrun codestream')

    if cs[pos:pos + 2] != b'\xff\xd9':
        _fail('packet walk did not land on EOC (at %d: %s)'
              % (pos, cs[pos:pos + 2].hex()))
    if psot != pos - sot_start:
        _fail('Psot %d != actual tile-part length %d'
              % (psot, pos - sot_start))
    if pos + 2 != len(cs):
        _fail('data after EOC')

    return {'w': w, 'h': h, 'ncomp': ncomp, 'ssiz': ssiz,
            'levels': levels, 'guard': guard, 'transform': transform,
            'blocks': total_blocks, 'included': included_blocks,
            'progression': prog, 'mct': mct, 'packet_walk': True}
