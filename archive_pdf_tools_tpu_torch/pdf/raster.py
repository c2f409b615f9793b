"""Whole-page rendering of ``--from-pdf`` pages that hold several images.

The shared ``archive_pdf_tools_tpu/pdf/raster.py`` interprets the page
and paints it; it decodes image XObjects through the JAX package's
``pipeline.recode._decode_pdf_image``, whose module imports jax.  This
``Rasterizer`` replaces that one method with a copy that calls the port's
copy of the decoder, and ``render_page_image`` is a copy of the shared
one on this ``Rasterizer``.  Text extraction (``pdf/textextract.py``)
runs the shared class in glyph-sink mode, which never decodes an image.
"""

import numpy as np

from archive_pdf_tools_tpu.pdf import raster as _shared
from archive_pdf_tools_tpu.pdf.reader import PStream


class Rasterizer(_shared.Rasterizer):

    def _decode_image_array(self, stream):
        """RGB float array in [0, 1] + optional alpha (H, W) or None."""
        from ..pipeline.recode import _decode_pdf_image
        r = self.reader
        d = stream.dict
        is_mask = bool(r.resolve(d.get('ImageMask')))
        w = int(r.resolve(d.get('Width')))
        h = int(r.resolve(d.get('Height')))
        if is_mask:
            data = stream.decoded()
            filt = r.resolve(d.get('Filter'))
            if isinstance(filt, list):
                filt = filt[-1] if filt else None
            if str(filt) == 'JBIG2Decode':
                from archive_pdf_tools_tpu.codecs.jbig2 import decode_jbig2
                bits = decode_jbig2(stream.raw, w, h)
            elif str(filt) == 'CCITTFaxDecode':
                from archive_pdf_tools_tpu.codecs.ccitt import (
                    decode_ccitt, pdf_fax_params)
                k, ba, b1 = pdf_fax_params(r.resolve, d)
                bits = np.asarray(decode_ccitt(
                    stream.raw, w, h, k=k, byte_align=ba,
                    black_is_1=b1))
            else:
                stride = (w + 7) // 8
                bits = np.unpackbits(
                    np.frombuffer(data[:stride * h],
                                  np.uint8).reshape(h, stride),
                    axis=1)[:, :w].astype(bool)
            # stencil semantics (8.9.6.2): sample 0 paints under the
            # default Decode [0 1]; Decode [1 0] flips
            samples = np.asarray(bits, bool)
            dec = r.resolve(d.get('Decode'))
            if dec and float(r.resolve(dec[0])) == 1.0:
                samples = ~samples
            return None, ~samples
        img = _decode_pdf_image(r, stream)
        arr = np.asarray(img.convert('RGB'), np.float32) / 255.0
        alpha = None
        sm = r.resolve(d.get('SMask'))
        if isinstance(sm, PStream):
            sarr = np.asarray(_decode_pdf_image(r, sm).convert('L'),
                              np.float32) / 255.0
            alpha = sarr
        return arr, alpha


def render_page_image(reader, idx, ppi=None):
    """Render page ``idx`` to a PIL image at ``ppi`` (default: the
    resolution of the page's largest embedded image, clamped to
    [72, 600], or 300 without images).  Collapses equal RGB channels to
    'L' and exact-binary pages to '1' (threshold, not dithered)."""
    from PIL import Image
    imgs = reader.page_images(idx)
    pw, _ph = reader.page_size(idx)
    if ppi is None:
        best = 0
        for _n, _x, stream in imgs:
            best = max(best, int(reader.resolve(stream.dict['Width'])))
        ppi = (best / (pw / 72.0)) if (best and pw) else 300.0
        ppi = min(max(ppi, 72.0), 600.0)
    arr = Rasterizer(reader).render_page(idx, scale=ppi / 72.0)
    if (arr[..., 0] == arr[..., 1]).all() and \
            (arr[..., 1] == arr[..., 2]).all():
        ch = arr[..., 0]
        if (((ch == 0) | (ch == 255))).all():
            return Image.fromarray(ch >= 128)
        return Image.fromarray(ch)
    return Image.fromarray(arr)
