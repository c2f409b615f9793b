"""MRC layer encoding for the in-tree JPEG2000 encoder (``-J tpu``).

The shared ``archive_pdf_tools_tpu.codecs.mrc_encode`` imports the JAX
package's ``jp2tpu`` for that implementation (``mrc_encode.py:148-167``),
so the port encodes ``-J tpu`` layers here, with its own ``jp2tpu``, and
hands every other implementation and format to the shared functions.
Same results (``EncodedLayer``), timing keys and component order.
"""

import time as _time

from archive_pdf_tools_tpu.codecs import mrc_encode as shared
from archive_pdf_tools_tpu.codecs.jpeg2000 import _pillow_kwargs
from archive_pdf_tools_tpu.const import (COMPRESSOR_JBIG2, COMPRESSOR_JPEG2000,
                                         JPEG2000_IMPL_PILLOW,
                                         JPEG2000_IMPL_TPU)

from .jp2tpu import encode_jp2_from_qbands, encode_jp2_tpu


def encode_mrc_img(np_img, img_compression_flags, imgtype=None,
                   jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
                   mrc_image_format=COMPRESSOR_JPEG2000, tmp_dir=None,
                   threads=None, timing_data=None, debug=False,
                   jp2_qbands=None, device=None):
    """fg/bg layer -> EncodedLayer (``mrc.py:523-580``).

    With ``-J tpu``: ``jp2_qbands`` is (page_qbands or a zero-argument
    fetch, meta, page_idx) from ``jp2tpu.transform_jp2_batch_async``, and
    ``np_img`` is then unused (None); otherwise ``np_img`` (numpy, sent to
    ``device``, or a uint8 tensor, used on its device) is transformed
    here."""
    if (jpeg2000_implementation != JPEG2000_IMPL_TPU
            or mrc_image_format != COMPRESSOR_JPEG2000):
        return shared.encode_mrc_img(
            np_img, img_compression_flags, imgtype=imgtype,
            jpeg2000_implementation=jpeg2000_implementation,
            mrc_image_format=mrc_image_format, tmp_dir=tmp_dir,
            threads=threads, timing_data=timing_data, debug=debug)
    t = _time.time()
    if imgtype not in ('bg', 'fg'):
        raise ValueError("imgtype should be 'bg' or 'fg'")
    kw = _pillow_kwargs(img_compression_flags[0]) \
        if img_compression_flags and img_compression_flags[0] else {}
    if jp2_qbands is not None:
        page_q, meta, page_idx = jp2_qbands
        if callable(page_q):
            page_q = page_q()
        data = encode_jp2_from_qbands(page_q, meta, ratio=kw.get('ratio'),
                                      workers=threads, page_idx=page_idx)
        h, w, gray = meta['h'], meta['w'], meta['ncomp'] == 1
    else:
        if np_img is None:
            raise ValueError('np_img=None needs jp2_qbands')
        data = encode_jp2_tpu(np_img, ratio=kw.get('ratio'),
                              base_delta=kw.get('delta', 1.0 / 64),
                              levels=int(kw.get('levels', 5)),
                              workers=threads, device=device)
        h, w = (int(s) for s in np_img.shape[:2])
        gray = len(np_img.shape) == 2
    if timing_data is not None:
        timing_data.append(('%s_jp2' % imgtype, _time.time() - t))
    return shared.EncodedLayer(data, mrc_image_format, w, h, gray)


def encode_mrc_images(mask, fg, bg, bg_compression_flags=None,
                      fg_compression_flags=None, mask_fmt=COMPRESSOR_JBIG2,
                      embedded_jbig2=True,
                      jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
                      mrc_image_format=COMPRESSOR_JPEG2000, tmp_dir=None,
                      threads=None, timing_data=None, debug=False,
                      fg_qbands=None, bg_qbands=None, device=None):
    """All three MRC components -> (EncodedMask, EncodedLayer,
    EncodedLayer), mask first, then fg, then bg (``mrc.py:633-673``).
    fg_qbands / bg_qbands: the page's ``-J tpu`` batch transform (see
    ``encode_mrc_img``)."""
    em = shared.encode_mrc_mask(mask, fmt=mask_fmt, embedded=embedded_jbig2,
                                timing_data=timing_data, debug=debug)
    common = dict(jpeg2000_implementation=jpeg2000_implementation,
                  mrc_image_format=mrc_image_format, tmp_dir=tmp_dir,
                  threads=threads, timing_data=timing_data, debug=debug,
                  device=device)
    ef = encode_mrc_img(fg, fg_compression_flags, imgtype='fg',
                        jp2_qbands=fg_qbands, **common)
    eb = encode_mrc_img(bg, bg_compression_flags, imgtype='bg',
                        jp2_qbands=bg_qbands, **common)
    return em, eb, ef
