# Copied from archive_pdf_tools_tpu/codecs/ccitt.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""CCITT Group 4 mask codec via Pillow/libtiff.

The reference's ``--mask-compression ccitt`` path defers G4 encoding to
PyMuPDF at save time; here we encode directly: Pillow writes a
single-strip G4 TIFF (libtiff, battle-tested) and we extract the raw
codestream for PDF embedding with ``/CCITTFaxDecode``.

Polarity (determined empirically against libtiff): mask True (text)
pixels are CCITT-black in the produced stream, so the PDF image dict
must carry ``/BlackIs1 true`` for text to decode as sample 1 (opaque in
an SMask).  ``decode_params()`` returns the matching DecodeParms.
"""

import io

import numpy as np
from PIL import Image


def encode_ccitt_g4(mask):
    """bool/uint8 (H, W) mask -> raw single-strip G4 codestream bytes."""
    m = np.asarray(mask).astype(bool)
    h, w = m.shape
    im = Image.fromarray(m)
    buf = io.BytesIO()
    im.save(buf, format='TIFF', compression='group4', tiffinfo={278: h})
    buf.seek(0)
    t = Image.open(buf)
    offsets = t.tag_v2[273]
    counts = t.tag_v2[279]
    if len(offsets) != 1:
        raise RuntimeError('expected single-strip G4 TIFF, got %d strips'
                           % len(offsets))
    raw = buf.getvalue()
    return raw[offsets[0]:offsets[0] + counts[0]]


def decode_params(w, h):
    """PDF DecodeParms dict source for streams from encode_ccitt_g4."""
    return ('<< /K -1 /Columns %d /Rows %d /BlackIs1 true >>' % (w, h))


def _tiff_wrap(stream, w, h, compression, options=None):
    """Minimal little-endian TIFF around a raw CCITT strip."""
    import struct

    def tag(tid, typ, cnt, val):
        return struct.pack('<HHI4s', tid, typ, cnt,
                           struct.pack('<I', val))

    tags = [tag(256, 4, 1, w), tag(257, 4, 1, h), tag(258, 3, 1, 1),
            tag(259, 3, 1, compression), tag(262, 3, 1, 1)]
    if options is not None:
        # 292 = T4Options (compression 3), 293 = T6Options (4)
        tags.append(tag(292 if compression == 3 else 293, 4, 1,
                        options))
    ntags = len(tags) + 3
    data_off = 8 + 2 + ntags * 12 + 4
    tags += [tag(273, 4, 1, data_off), tag(278, 4, 1, h),
             tag(279, 4, 1, len(stream))]
    tags.sort(key=lambda t: t[:2])        # IFD entries must be ordered
    ifd = struct.pack('<H', ntags) + b''.join(tags) \
        + struct.pack('<I', 0)
    return b'II*\x00' + struct.pack('<I', 8) + ifd + bytes(stream)


def decode_ccitt(stream, w, h, k=-1, byte_align=False,
                 black_is_1=True):
    """Decode a PDF /CCITTFaxDecode payload via libtiff.

    Maps the PDF parameter space (ISO 32000-1 7.4.6) onto TIFF
    compression schemes: /K < 0 -> T.6 (G4); /K = 0 with
    /EncodedByteAlign -> Modified Huffman (TIFF 2, byte-aligned 1-D
    rows); /K >= 0 otherwise -> T.4 (TIFF 3), 2-D when K > 0 — the
    reference decodes all of these through PyMuPDF's MuPDF fax
    decoder.  Returns the PDF SAMPLE bits as bool (H, W): black pixels
    are 1 iff ``black_is_1`` (the PDF default is false; our own
    encoder always writes /BlackIs1 true, see decode_params)."""
    stream = bytes(stream)
    if k < 0:
        candidates = [(4, None)]
    elif k == 0 and byte_align:
        candidates = [(2, None), (3, 4 if byte_align else 0)]
    else:
        opts = (1 if k > 0 else 0) | (4 if byte_align else 0)
        candidates = [(3, opts), (2, None)]
    err = None
    for comp, opts in candidates:
        try:
            im = Image.open(io.BytesIO(
                _tiff_wrap(stream, w, h, comp, opts)))
            black = np.asarray(im)
            break
        except Exception as e:            # try the next mapping
            err = e
    else:
        raise ValueError('CCITT decode failed (K=%d): %s' % (k, err))
    return black if black_is_1 else ~black


def decode_ccitt_g4(stream, w, h):
    """Round-trip helper for streams from ``encode_ccitt_g4`` (G4,
    /BlackIs1 true).  Returns bool (H, W) with True = text."""
    return decode_ccitt(stream, w, h, k=-1, black_is_1=True)


def pdf_fax_params(resolve, image_dict):
    """(k, byte_align, black_is_1) from a PDF image dict's
    /DecodeParms (defaults per ISO 32000-1 Table 11)."""
    parms = resolve(image_dict.get('DecodeParms'))
    if isinstance(parms, list):
        found = None
        for p in parms:
            p = resolve(p)
            if isinstance(p, dict) and (
                    'K' in p or 'BlackIs1' in p or 'Columns' in p
                    or 'EncodedByteAlign' in p):
                found = p
        parms = found
    if not isinstance(parms, dict):
        parms = {}
    try:
        k = int(resolve(parms.get('K', 0)) or 0)
    except (TypeError, ValueError):
        k = 0
    return (k, bool(resolve(parms.get('EncodedByteAlign'))),
            bool(resolve(parms.get('BlackIs1'))))
