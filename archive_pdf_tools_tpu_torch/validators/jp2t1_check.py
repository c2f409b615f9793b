# Copied from archive_pdf_tools_tpu/validators/jp2t1_check.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""From-spec ITU-T T.800 EBCOT Tier-1 block DECODER (validation only).

Closes the decode-side loop on the in-tree `-J tpu` encoder without any
external codec: `decode_block` runs the three coding passes (D.3/D.4)
against the shared MQ arithmetic decoder (T.800 Annex C == T.88 —
reused from validators/jbig2_check.MQDecoder) and reconstructs every
coefficient's magnitude and sign.  A fully-coded block must round-trip
bit-exactly; a block truncated at a plane boundary must equal the
input with the uncoded low planes masked off
(tests/test_jp2t1_decode.py).

Deliberately written as a direct neighbourhood-reading implementation
(2-D state arrays, contexts recomputed from the spec's tables at every
decision) rather than mirroring the encoder's incremental flag-word /
LUT machinery (native/jp2t1.cpp), so a shared bookkeeping bug cannot
cancel out.  Same-author caveat as the other from-spec validators
(VERDICT r2); the external cross-checks are the Pillow/OpenJPEG
decodes in the conformance tests.

Reference parity note: the reference ships no JPEG2000 implementation
at all (jpeg2000.py drives external Kakadu/OpenJPEG/Grok binaries);
this validator exists because our encoder is in-tree.
"""

from .jbig2_check import MQDecoder

__all__ = ['decode_block', 'Jp2T1DecodeError']


class Jp2T1DecodeError(ValueError):
    pass


def _zc_context(orient, h, v, d):
    """Zero-coding context number, T.800 Table D.1 (columns LL/LH, HL,
    HH).  h/v/d = significant horizontal / vertical / diagonal
    neighbour counts; HL swaps h and v (the table's own symmetry)."""
    if orient == 1:           # HL: primary direction is vertical
        h, v = v, h
    if orient != 2:           # LL / LH (and swapped HL)
        if h == 2:
            return 8
        if h == 1:
            if v >= 1:
                return 7
            return 6 if d >= 1 else 5
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else d
    hv = h + v                # HH
    if d >= 3:
        return 8
    if d == 2:
        return 7 if hv >= 1 else 6
    if d == 1:
        if hv >= 2:
            return 5
        return 4 if hv == 1 else 3
    return 2 if hv >= 2 else hv


def _sc_context(hc, vc):
    """Sign-coding context and XOR bit, T.800 Table D.3.
    hc/vc in {-1, 0, 1} (clamped neighbour sign contributions)."""
    if hc == 1:
        if vc == 1:
            return 13, 0
        return (12, 0) if vc == 0 else (11, 0)
    if hc == 0:
        if vc == 1:
            return 10, 0
        if vc == 0:
            return 9, 0
        return 10, 1
    if vc == 1:
        return 11, 1
    return (12, 1) if vc == 0 else (13, 1)


_CTX_RL = 17
_CTX_UNI = 18
_NCTX = 19


def decode_block(data, w, h, orient, nbps, npasses):
    """Decode one EBCOT code block -> (mag, sgn) lists of length w*h.

    data: the cleanly-flushed MQ codeword segment (all npasses passes;
    the in-tree encoder realises truncation by re-encoding, so every
    emitted stream satisfies this).
    orient: 0 = LL/LH, 1 = HL, 2 = HH (the encoder's orient codes).
    nbps: magnitude bit planes; the first pass is the cleanup pass of
    plane nbps-1 (D.4.1).
    """
    if w <= 0 or h <= 0:
        raise Jp2T1DecodeError('empty block')
    mq = MQDecoder(bytes(data) + b'')
    # context states as [index, mps]; initial indices per D.7
    cx = [[0, 0] for _ in range(_NCTX)]
    cx[0][0] = 4
    cx[_CTX_RL][0] = 3
    cx[_CTX_UNI][0] = 46

    sig = [[False] * w for _ in range(h)]
    neg = [[False] * w for _ in range(h)]
    refined = [[False] * w for _ in range(h)]
    visited = [[False] * w for _ in range(h)]
    mag = [[0] * w for _ in range(h)]

    def nbr_counts(x, y):
        hh = vv = dd = 0
        for dx in (-1, 1):
            if 0 <= x + dx < w and sig[y][x + dx]:
                hh += 1
            if 0 <= y + dx < h and sig[y + dx][x]:
                vv += 1
        for dy in (-1, 1):
            for dx in (-1, 1):
                yy, xx = y + dy, x + dx
                if 0 <= yy < h and 0 <= xx < w and sig[yy][xx]:
                    dd += 1
        return hh, vv, dd

    def any_sig_nbr(x, y):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                yy, xx = y + dy, x + dx
                if 0 <= yy < h and 0 <= xx < w and sig[yy][xx]:
                    return True
        return False

    def contrib(x, y):
        if not (0 <= x < w and 0 <= y < h) or not sig[y][x]:
            return 0
        return -1 if neg[y][x] else 1

    def decode_sign(x, y):
        hc = contrib(x - 1, y) + contrib(x + 1, y)
        vc = contrib(x, y - 1) + contrib(x, y + 1)
        hc = max(-1, min(1, hc))
        vc = max(-1, min(1, vc))
        c, xorbit = _sc_context(hc, vc)
        return mq.decode(cx[c]) ^ xorbit

    def become_sig(x, y, p):
        sig[y][x] = True
        mag[y][x] |= 1 << p
        neg[y][x] = bool(decode_sign(x, y))

    def sig_pass(p):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y][x] or not any_sig_nbr(x, y):
                        continue
                    hh, vv, dd = nbr_counts(x, y)
                    bit = mq.decode(cx[_zc_context(orient, hh, vv, dd)])
                    if bit:
                        become_sig(x, y, p)
                    visited[y][x] = True

    def mag_pass(p):
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if not sig[y][x] or visited[y][x]:
                        continue
                    if refined[y][x]:
                        c = 16
                    else:
                        c = 15 if any_sig_nbr(x, y) else 14
                    if mq.decode(cx[c]):
                        mag[y][x] |= 1 << p
                    refined[y][x] = True

    def cleanup_pass(p):
        for y0 in range(0, h, 4):
            full = y0 + 4 <= h
            for x in range(w):
                y = y0
                if full and all(
                        not sig[y0 + k][x] and not visited[y0 + k][x]
                        and not any_sig_nbr(x, y0 + k)
                        for k in range(4)):
                    if not mq.decode(cx[_CTX_RL]):
                        continue          # whole column insignificant
                    first = (mq.decode(cx[_CTX_UNI]) << 1) \
                        | mq.decode(cx[_CTX_UNI])
                    become_sig(x, y0 + first, p)
                    y = y0 + first + 1
                for y in range(y, min(y0 + 4, h)):
                    if visited[y][x]:
                        visited[y][x] = False
                        continue
                    if sig[y][x]:
                        continue
                    hh, vv, dd = nbr_counts(x, y)
                    bit = mq.decode(cx[_zc_context(orient, hh, vv, dd)])
                    if bit:
                        become_sig(x, y, p)
        for row in visited:
            for x in range(w):
                row[x] = False

    npass = 0
    for p in range(nbps - 1, -1, -1):
        if p < nbps - 1:
            if npass < npasses:
                sig_pass(p)
                npass += 1
            if npass < npasses:
                mag_pass(p)
                npass += 1
        if npass < npasses:
            cleanup_pass(p)
            npass += 1
        if npass >= npasses:
            break
    if npass < npasses:
        raise Jp2T1DecodeError(
            'npasses %d exceeds the %d passes %d planes allow'
            % (npasses, npass, nbps))

    out_mag = [mag[y][x] for y in range(h) for x in range(w)]
    out_sgn = [1 if neg[y][x] else 0 for y in range(h) for x in range(w)]
    return out_mag, out_sgn
