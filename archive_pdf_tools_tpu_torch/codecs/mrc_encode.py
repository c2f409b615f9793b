# Copied from archive_pdf_tools_tpu/codecs/mrc_encode.py, with the
# port's -J tpu layer encode (the in-tree encoder's device transform on
# the torch device, codecs/jp2tpu.py) in encode_mrc_img and a ``device``
# argument through encode_mrc_img / encode_mrc_images; kept by hand.
"""MRC component encoding: mask/fg/bg arrays -> compressed streams.

In-memory re-architecture of the reference's encode layer
(``mrc.py:474-673``): where the reference writes every layer through
tempfiles and subprocesses, we encode in-process by default (own JBIG2,
Pillow JPEG2000/JPEG/PNG, libtiff G4) and only touch the filesystem for
the optional external Kakadu/Grok/OpenJPEG backends.

Mask polarity: the mask arrays are True at ink.  Following the
reference's PNG convention (ink saved white, ``mrc.py:491-499``), ink
pixels are encoded as JBIG2/CCITT *white* so PDF SMask decoding yields
alpha 1 (opaque foreground) at text.
"""

import io
from collections import namedtuple
from os import close, remove
from tempfile import mkstemp

import numpy as np
from PIL import Image

from ..const import (COMPRESSOR_JPEG, COMPRESSOR_JPEG2000, COMPRESSOR_JBIG2,
                     COMPRESSOR_CCITT, JPEG2000_IMPL_PILLOW)
from ..utils.spans import span
from ..utils.workers import take, timed
from . import jbig2 as jbig2_codec
from . import ccitt as ccitt_codec
from . import jpeg as jpeg_codec
from . import pillow_jp2
from .jpeg2000 import encode_jpeg2000

EncodedMask = namedtuple('EncodedMask', 'data fmt width height decode')
EncodedMask.__new__.__defaults__ = (None,)
EncodedLayer = namedtuple('EncodedLayer', 'data fmt width height gray')

# Bit-packed mask page: bits is (H, ceil(W/8)) uint8 in np.packbits row
# layout — exactly what the device mask transfer produces, so the
# pipeline can hand masks to the JBIG2 encoder without a host unpack.
PackedMask = namedtuple('PackedMask', 'bits width height')

# the timing key (and span) of each mask format
_MASK_KEYS = {COMPRESSOR_JBIG2: 'mask_jbig2', COMPRESSOR_CCITT: 'mask_ccitt',
             'png': 'mask_png'}


def encode_mrc_mask(np_mask, fmt=COMPRESSOR_JBIG2, embedded=True,
                    timing_data=None, debug=False, jbig2_symbol_mode=False,
                    jbig2_bands=1):
    """Mask -> EncodedMask. fmt: jbig2 | ccitt | png (``mrc.py:474-520``).

    jbig2_symbol_mode (beyond the reference, which always emits a plain
    generic region): False / True / 'auto' symbol-dictionary coding —
    still lossless (exact-match symbol classes only).

    jbig2_bands > 1 (generic mode): code the page as that many
    independent horizontal region segments on a thread pool — the MQ
    coder is serial per region, so this is how the mask encode scales
    across host cores."""
    if fmt not in _MASK_KEYS:
        raise ValueError('unknown mask format: %r' % (fmt,))
    with span(_MASK_KEYS[fmt], timing_data):
        packed = None
        if isinstance(np_mask, PackedMask):
            h, w = np_mask.height, np_mask.width
            if (fmt == COMPRESSOR_JBIG2 and not jbig2_symbol_mode
                    and jbig2_bands <= 1):
                packed = np_mask.bits     # fast path: no host unpack at all
                m = None
            else:
                m = np.unpackbits(np.asarray(np_mask.bits),
                                  axis=-1)[:, :w].astype(bool)
        else:
            m = np.asarray(np_mask).astype(bool)
            h, w = m.shape
        decode = None
        if packed is not None:
            # ink stored as jbig2 white (see the polarity note below), via
            # the packed-row encoder: bit-identical with the unpacked path
            data = jbig2_codec.encode_jbig2_packed(packed, w, h, invert=True,
                                                   embedded=embedded)
            return EncodedMask(data, fmt, w, h, None)
        if fmt == COMPRESSOR_JBIG2:
            # ink is stored as jbig2 *white* so the PDF sample (which PDF
            # consumers invert relative to the jbig2 bit) is 1 at text.
            # Symbol coding needs ink as the 1 bits (connected components of
            # text, not of paper), so it stores ink as jbig2 black and flips
            # back with a /Decode [1 0] array on the image dict.
            if jbig2_symbol_mode:
                data = jbig2_codec.encode_jbig2(
                    m, embedded=embedded,
                    symbol_mode=jbig2_symbol_mode
                    if jbig2_symbol_mode in ('lossy', 'refine') else True)
                decode = (1, 0)
                if jbig2_symbol_mode == 'auto':
                    gen = jbig2_codec.encode_jbig2(~m, embedded=embedded)
                    if len(gen) <= len(data):
                        data, decode = gen, None
            else:
                data = jbig2_codec.encode_jbig2(~m, embedded=embedded,
                                                bands=jbig2_bands)
        elif fmt == COMPRESSOR_CCITT:
            data = ccitt_codec.encode_ccitt_g4(m)
        else:
            buf = io.BytesIO()
            Image.fromarray(m).save(buf, format='PNG', compress_level=0)
            data = buf.getvalue()
        return EncodedMask(data, fmt, w, h, decode)


def encode_mrc_img(np_img, img_compression_flags, imgtype=None,
                   jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
                   mrc_image_format=COMPRESSOR_JPEG2000,
                   tmp_dir=None, threads=None, timing_data=None,
                   debug=False, jp2_qbands=None, device=None,
                   encoders=None):
    """fg/bg layer -> EncodedLayer (``mrc.py:523-580``).

    encoders: worker processes (``utils/workers.py`` ``ENCODERS``)
    that encode a ``-J pillow`` JPEG2000 layer while this thread waits
    off the interpreter lock; None encodes it on this thread.

    jp2_qbands: optional (page_qbands, meta) from
    jp2tpu.transform_jp2_batch — the '-J tpu' batched path, where the
    whole page batch's DWT ran as one device dispatch and only the host
    Tier-1 remains to be done here.  page_qbands may also be a
    zero-arg callable (transform_jp2_batch_async's fetch, bound to one
    page): it is resolved AFTER the mask encode so the band readback
    overlaps host work.  With qbands, np_img may be None — the layer
    pixels then never cross the host link at all (geometry comes from
    the transform meta)."""
    if imgtype not in ('bg', 'fg'):
        raise ValueError("imgtype should be 'bg' or 'fg'")
    with span('%s_jp2' % imgtype, timing_data):
        if np_img is None:
            if jp2_qbands is None or jpeg2000_implementation != 'tpu' \
                    or mrc_image_format == COMPRESSOR_JPEG:
                raise ValueError('np_img=None requires the tpu qbands path')
            qmeta = jp2_qbands[1]
            gray = qmeta['ncomp'] == 1
            h, w = qmeta['h'], qmeta['w']
            img = None
        else:
            gray = len(np_img.shape) == 2
            h, w = (int(s) for s in np_img.shape[:2])
            img = None
            if jpeg2000_implementation not in ('tpu', JPEG2000_IMPL_PILLOW) \
                    or mrc_image_format == COMPRESSOR_JPEG:
                img = Image.fromarray(np.asarray(np_img))

        if mrc_image_format == COMPRESSOR_JPEG:
            data = jpeg_codec.encode_jpeg(img, img_compression_flags,
                                          debug=debug)
        else:
            if jpeg2000_implementation == 'tpu':
                # in-tree encoder: the port's device transform + host Tier-1
                from .jp2tpu import encode_jp2_tpu, encode_jp2_from_qbands
                from .jpeg2000 import _pillow_kwargs
                kw = (_pillow_kwargs(img_compression_flags[0])
                      if img_compression_flags and img_compression_flags[0]
                      else {})
                if jp2_qbands is not None:
                    page_q, meta = jp2_qbands[:2]
                    page_idx = jp2_qbands[2] if len(jp2_qbands) > 2 else None
                    if callable(page_q):
                        page_q = page_q()
                    data = encode_jp2_from_qbands(page_q, meta,
                                                  ratio=kw.get('ratio'),
                                                  workers=threads,
                                                  page_idx=page_idx)
                else:
                    data = encode_jp2_tpu(np_img, ratio=kw.get('ratio'),
                                          base_delta=kw.get('delta', 1.0 / 64),
                                          levels=int(kw.get('levels', 5)),
                                          workers=threads, device=device)
            elif jpeg2000_implementation == JPEG2000_IMPL_PILLOW:
                flags = img_compression_flags[0]
                if encoders is None:
                    data = pillow_jp2.encode(np_img, flags)
                else:
                    data = take(encoders.submit(
                        timed, pillow_jp2.encode, np.asarray(np_img),
                        flags).result(), 'jp2_pillow', 'encode-proc')
            else:
                fd, out_path = mkstemp(prefix=imgtype, suffix='.jp2',
                                       dir=tmp_dir)
                close(fd)
                remove(out_path)  # kakadu wants the file absent (mrc.py:555)
                try:
                    encode_jpeg2000(img, out_path, jpeg2000_implementation,
                                    img_compression_flags, tmp_dir=tmp_dir,
                                    imgtype=imgtype, threads=threads,
                                    debug=debug)
                    with open(out_path, 'rb') as fp:
                        data = fp.read()
                finally:
                    try:
                        remove(out_path)
                    except FileNotFoundError:
                        pass
        return EncodedLayer(data, mrc_image_format, w, h, gray)


def encode_mrc_foreground(np_fg, fg_compression_flags, **kw):
    """``mrc.py:608-630``"""
    return encode_mrc_img(np_fg, fg_compression_flags, imgtype='fg', **kw)


def encode_mrc_background(np_bg, bg_compression_flags, **kw):
    """``mrc.py:583-605``"""
    return encode_mrc_img(np_bg, bg_compression_flags, imgtype='bg', **kw)


def encode_mrc_images(mask, fg, bg, bg_compression_flags=None,
                      fg_compression_flags=None, mask_fmt=COMPRESSOR_JBIG2,
                      embedded_jbig2=True,
                      jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
                      mrc_image_format=COMPRESSOR_JPEG2000,
                      tmp_dir=None, threads=None, timing_data=None,
                      debug=False, jbig2_symbol_mode=False, jbig2_bands=1,
                      fg_qbands=None, bg_qbands=None, device=None,
                      encoders=None):
    """All three MRC components -> (EncodedMask, EncodedLayer, EncodedLayer).
    In-memory analog of ``mrc.py:633-673``.  fg_qbands/bg_qbands carry
    pre-transformed '-J tpu' coefficients (one batched device dispatch
    upstream, see pipeline/recode.py process_batch)."""
    em = encode_mrc_mask(mask, fmt=mask_fmt, embedded=embedded_jbig2,
                         timing_data=timing_data, debug=debug,
                         jbig2_symbol_mode=jbig2_symbol_mode,
                         jbig2_bands=jbig2_bands)
    ef = encode_mrc_foreground(
        fg, fg_compression_flags,
        jpeg2000_implementation=jpeg2000_implementation,
        mrc_image_format=mrc_image_format, tmp_dir=tmp_dir,
        threads=threads, timing_data=timing_data, debug=debug,
        jp2_qbands=fg_qbands, device=device, encoders=encoders)
    eb = encode_mrc_background(
        bg, bg_compression_flags,
        jpeg2000_implementation=jpeg2000_implementation,
        mrc_image_format=mrc_image_format, tmp_dir=tmp_dir,
        threads=threads, timing_data=timing_data, debug=debug,
        jp2_qbands=bg_qbands, device=device, encoders=encoders)
    return em, eb, ef
