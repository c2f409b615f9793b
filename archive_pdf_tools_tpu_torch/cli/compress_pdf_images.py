# Copied from archive_pdf_tools_tpu/cli/compress_pdf_images.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: a --device for the MRC (default cuda:0), the mask fetched from the device.
"""compress-pdf-images: in-place MRC recompression of a PDF's images.

Capability parity with the reference's ``bin/compress-pdf-images``:
extract each page's image, MRC-decompose it (hOCR-guided when an hOCR
file is given), drop the original image from the page's content stream
and resources, and splice in the bg + fg/mask stack.  The reference
hardcodes Kakadu slopes 44250/44500 (``bin/compress-pdf-images:72-74``);
we default to the Pillow JPEG2000 backend with equivalent rate targets
when Kakadu is absent.
"""

import argparse
import sys

import numpy as np

from ..const import (COMPRESSOR_JBIG2, COMPRESSOR_JPEG2000,
                     JPEG2000_IMPL_KAKADU, JPEG2000_IMPL_PILLOW,
                     DENOISE_FAST)
from ..inputs.hocr import hocr_page_iterator, hocr_page_to_word_data
from ..pdf.reader import PdfReader
from ..pdf.rewrite import PdfRewriter, replace_image_ops
from ..pdf.writer import Name, Stream
from ..mrc.api import decompose_masks, decompose_layers
from ..codecs.mrc_encode import encode_mrc_images
from ..codecs.jpeg2000 import impl_available


def _map_word_data(word_data, sx, sy, ox, oy, iw, ih):
    """Affine-map hOCR line/word boxes and clip them to the image;
    lines that land outside entirely are dropped."""
    out = []
    for par in word_data:
        lines = []
        for line in par.get('lines', ()):
            l, t, r, b = line['bbox']
            box = [l * sx + ox, t * sy + oy, r * sx + ox, b * sy + oy]
            box = [max(0.0, min(box[0], iw)), max(0.0, min(box[1], ih)),
                   max(0.0, min(box[2], iw)), max(0.0, min(box[3], ih))]
            if box[2] - box[0] < 1 or box[3] - box[1] < 1:
                continue
            nl = dict(line)
            nl['bbox'] = box
            nl['words'] = [
                dict(w, bbox=[w['bbox'][0] * sx + ox,
                              w['bbox'][1] * sy + oy,
                              w['bbox'][2] * sx + ox,
                              w['bbox'][3] * sy + oy])
                for w in line.get('words', ())]
            lines.append(nl)
        if lines:
            out.append({'lines': lines})
    return out


def _word_data_for_image(reader, page_idx, word_data, hocr_dims,
                         placement, image_size):
    """Map page-raster hOCR boxes into one image's pixel space.

    hOCR boxes live on the page raster (hocr_dims px over the full
    page); the image covers only its placement rect (top-left-origin
    page units).  The reference re-derives boxes per image via
    fitz's get_image_bbox (``bin/compress-pdf-images:44-61``)."""
    if not word_data or not hocr_dims or not hocr_dims[0] \
            or not hocr_dims[1]:
        return word_data
    iw, ih = image_size
    page = reader.pages()[page_idx]
    box = reader._inherited(page, 'MediaBox') or [0, 0, 612, 792]
    box = [float(reader.resolve(v)) for v in box]
    pw, ph = box[2] - box[0], box[3] - box[1]
    wh, hh = hocr_dims
    # hocr px -> page units
    ux, uy = pw / wh, ph / hh
    if placement is not None:
        a, b, c, d, e, f = placement
        xs = [e, a + e, c + e, a + c + e]
        ys = [f, b + f, d + f, b + d + f]
        rx0, ry0 = min(xs), min(ys)
        rw, rh = max(xs) - rx0, max(ys) - ry0
        if rw > 1e-3 and rh > 1e-3:
            sx, sy = ux * iw / rw, uy * ih / rh
            return _map_word_data(word_data, sx, sy,
                                  -rx0 * iw / rw, -ry0 * ih / rh,
                                  iw, ih)
    # fallback: image assumed to cover the page
    return _map_word_data(word_data, iw / wh, ih / hh, 0.0, 0.0, iw, ih)


def _already_mrc(reader, stream):
    """True for JPXDecode/JBIG2Decode images (an MRC stack's own
    parts): recompressing those inflates them."""
    filt = reader.resolve(stream.dict.get('Filter'))
    filts = filt if isinstance(filt, list) else [filt]
    names = {str(reader.resolve(f)) for f in filts if f is not None}
    return bool(names & {'JPXDecode', 'JBIG2Decode'})


def compress_page_images(rw, reader, page_idx, word_data,
                         bg_flags, fg_flags, impl, bg_downsample=3,
                         dpi=None, errors=None, verbose=False,
                         hocr_dims=None, recompress_mrc=False,
                         device=None):
    """MRC-recompress every image on a page, in place: each `/ImN Do`
    is substituted with bg + fg(SMask=mask) draws inside the original
    transform context — the reference likewise iterates all page
    images (``bin/compress-pdf-images:44-127``), re-deriving bboxes via
    get_image_bbox where we keep the original CTM."""
    imgs = reader.page_images(page_idx)
    if not imgs:
        return False
    from ..pipeline.recode import _decode_pdf_image

    placements = {}
    if word_data and hocr_dims:
        from ..pdf.raster import image_placements
        try:
            for pname, transform, _num, _stream in \
                    image_placements(reader, page_idx):
                placements.setdefault(pname, transform)
        except Exception:
            placements = {}

    mapping = {}
    res_updates = {}
    for img_i, (name, _xobj_num, stream) in enumerate(imgs):
        if not recompress_mrc and _already_mrc(reader, stream):
            if verbose:
                print('page %d image %s: already JPX/JBIG2, keeping '
                      '(--recompress-mrc overrides)' % (page_idx, name),
                      file=sys.stderr)
            continue
        try:
            image = _decode_pdf_image(reader, stream)
        except Exception as exc:
            if verbose:
                print('page %d image %s: cannot decode (%s), keeping'
                      % (page_idx, name, exc), file=sys.stderr)
            continue
        if image.mode in ('RGBA', 'LA', 'P'):
            image = image.convert('RGB' if image.mode != 'LA' else 'L')
        if image.mode not in ('L', 'RGB'):
            image = image.convert('RGB')
        if image.size[0] < 32 or image.size[1] < 32:
            continue        # icons/rules: not worth an MRC stack

        wd_img = word_data
        if word_data and hocr_dims:
            wd_img = _word_data_for_image(
                reader, page_idx, word_data, hocr_dims,
                placements.get(name), image.size)

        arr = np.asarray(image)
        mask_dev, dev_imgs = decompose_masks(
            [arr], [wd_img or []], dpi=dpi,
            denoise_mask=DENOISE_FAST, device=device)
        fg, bg = decompose_layers(mask_dev, dev_imgs,
                                  bg_downsample=bg_downsample,
                                  errors=errors)
        em, eb, ef = encode_mrc_images(
            mask_dev[0].cpu().numpy(), fg[0], bg[0],
            bg_compression_flags=bg_flags,
            fg_compression_flags=fg_flags,
            mask_fmt=COMPRESSOR_JBIG2, embedded_jbig2=True,
            jpeg2000_implementation=impl,
            mrc_image_format=COMPRESSOR_JPEG2000)

        gray = image.mode == 'L'

        def xdict(enc, is_mask=False, smask=None):
            d = {Name('Type'): Name('XObject'),
                 Name('Subtype'): Name('Image'),
                 Name('Width'): enc.width, Name('Height'): enc.height}
            if is_mask:
                d[Name('BitsPerComponent')] = 1
                d[Name('ColorSpace')] = Name('DeviceGray')
                d[Name('Filter')] = Name('JBIG2Decode')
            else:
                d[Name('BitsPerComponent')] = 8
                d[Name('ColorSpace')] = Name('DeviceGray' if gray
                                             else 'DeviceRGB')
                d[Name('Filter')] = Name('JPXDecode')
            if smask is not None:
                d[Name('SMask')] = smask
            return d

        bg_ref = rw.add_object(Stream(xdict(eb), eb.data))
        mask_ref = rw.add_object(Stream(xdict(em, is_mask=True),
                                        em.data))
        fg_ref = rw.add_object(Stream(xdict(ef, smask=mask_ref),
                                      ef.data))
        bg_name = 'MRCbg' if img_i == 0 else 'MRCbg%d' % img_i
        fg_name = 'MRCfg' if img_i == 0 else 'MRCfg%d' % img_i
        mapping[name] = [bg_name, fg_name]
        res_updates[bg_name] = bg_ref
        res_updates[fg_name] = fg_ref

    if not mapping:
        return False

    # rewrite the page: substitute the image ops in place
    page_ref = rw.page_ref(page_idx)
    page = dict(rw.get_object(page_ref))
    content = reader.page_contents(page_idx)
    new_content = replace_image_ops(content, mapping)
    content_ref = rw.add_object(Stream({}, new_content, deflate=True))
    page[Name('Contents')] = content_ref

    res = reader.resolve(reader.pages()[page_idx].get('Resources')) or {}
    from ..pdf.rewrite import _convert
    res_w = _convert(res)
    xobjs = dict(res_w.get(Name('XObject'), {}))
    for old_name in mapping:
        xobjs.pop(Name(old_name), None)
    for new_name, ref in res_updates.items():
        xobjs[Name(new_name)] = ref
    res_w[Name('XObject')] = xobjs
    page[Name('Resources')] = res_w
    rw.set_object(page_ref, page)
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Recompress the images of a PDF with MRC in place.')
    parser.add_argument('infile')
    parser.add_argument('hocr', nargs='?', default=None,
                        help='optional hOCR for text-guided masks')
    parser.add_argument('outfile')
    parser.add_argument('--bg-downsample', type=int, default=3)
    parser.add_argument('--dpi', type=int, default=None)
    parser.add_argument('--recompress-mrc', action='store_true',
                        help='also recompress images that are already '
                             'JPX/JBIG2 (an existing MRC stack); off by '
                             'default because it inflates them')
    parser.add_argument('-v', '--verbose', action='store_true')
    parser.add_argument('--device', default='cuda:0',
                        help="torch device (default cuda:0; 'cpu' runs the "
                             'plain PyTorch versions of the kernels)')
    args = parser.parse_args(argv)
    from ..utils.backend import resolve_device
    device = resolve_device(args.device)

    if impl_available(JPEG2000_IMPL_KAKADU):
        impl = JPEG2000_IMPL_KAKADU
        bg_flags, fg_flags = ['-slope', '44250'], ['-slope', '44500']
    else:
        impl = JPEG2000_IMPL_PILLOW
        bg_flags = ['quality_mode:"rates";quality_layers:[500]']
        fg_flags = ['quality_mode:"rates";quality_layers:[750]']

    reader = PdfReader(args.infile)
    rw = PdfRewriter(reader)

    word_datas = [None] * reader.page_count()
    hocr_dims = [None] * reader.page_count()
    if args.hocr:
        from ..inputs.hocr import hocr_page_get_dimensions
        for idx, page in enumerate(hocr_page_iterator(args.hocr)):
            if idx >= len(word_datas):
                break
            word_datas[idx] = hocr_page_to_word_data(page)
            hocr_dims[idx] = hocr_page_get_dimensions(page)

    n = 0
    for idx in range(reader.page_count()):
        if compress_page_images(rw, reader, idx, word_datas[idx],
                                bg_flags, fg_flags, impl,
                                bg_downsample=args.bg_downsample,
                                dpi=args.dpi, verbose=args.verbose,
                                hocr_dims=hocr_dims[idx],
                                recompress_mrc=args.recompress_mrc,
                                device=device):
            n += 1
    rw.save(args.outfile)
    import os
    old = os.path.getsize(args.infile)
    new = os.path.getsize(args.outfile)
    print('Compressed %d pages: %d -> %d bytes (%.2fx)'
          % (n, old, new, old / max(new, 1)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
