# Copied from archive_pdf_tools_tpu/cli/pdf_to_imagestack.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""pdf-to-imagestack: rasterize a PDF into a zip of TIFFs or JP2s.

Capability parity with ``bin/pdf-to-imagestack``: produce an imagestack
zip (CCITT G4 TIFFs for bitonal content, JPEG2000 otherwise).  Pages
that are exactly one full-page image extract losslessly (better than
the reference's re-render); anything else — vector-only pages, text
pages, multi-image composites — renders through the in-tree
content-stream rasterizer (pdf/raster.py), matching the reference's
rasterize-anything behaviour (``bin/pdf-to-imagestack:18-72``).
"""

import argparse
import io
import sys
import zipfile

from PIL import Image

from ..pdf.reader import PdfReader


def page_image(reader, idx, ppi=None):
    """Lossless single-image fast path, else rasterize the page."""
    imgs = reader.page_images(idx)
    if len(imgs) == 1:
        _name, _num, stream = imgs[0]
        raw, filt, w, h, cs = reader.extract_image(stream)
        try:
            img = Image.open(io.BytesIO(raw))
            img.load()
            return img
        except Exception:
            pass    # JBIG2/CCITT/Flate or broken: rasterize below
    from ..pdf.raster import render_page_image
    return render_page_image(reader, idx, ppi=ppi)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # the reference's positional signature
    # (``bin/pdf-to-imagestack:75``): in_pdf in_json identifier out_zip
    # — exactly four arguments, no flags (flag VALUES must not be
    # miscounted as positionals, so any '-' argument disables this)
    if len(argv) == 4 and not any(a.startswith('-') for a in argv):
        i_pdf, i_json, ident, o_zip = argv
        argv = [i_pdf, o_zip, '--json', i_json, '--identifier', ident]

    parser = argparse.ArgumentParser(
        description='Convert a PDF to an imagestack zip.')
    parser.add_argument('infile')
    parser.add_argument('outzip')
    parser.add_argument('--format', choices=['tiff', 'jp2', 'auto'],
                        default='auto')
    parser.add_argument('--jp2-rate', type=int, default=100,
                        help='Pillow JPEG2000 rate (quality_layers)')
    parser.add_argument('--ppi', type=float, default=None,
                        help='render resolution for rasterized pages '
                             '(default: the metadata JSON scale, else '
                             'match the page images, or 300)')
    parser.add_argument('-J', '--json', default=None,
                        help='pdf-metadata-json report: per-page render '
                             'scale + whole-stack tif/jp2 decision')
    parser.add_argument('--identifier', default=None,
                        help='archive.org-style member naming: '
                             'ID_tif/ID_0000.tif')
    args = parser.parse_args(argv)

    page_meta = None
    if args.json:
        import json as _json
        with open(args.json) as fp:
            meta = _json.load(fp)
        page_meta = meta.get('page_data') or []
        if args.format == 'auto':
            # reference policy: TIFF only when every page's images are
            # all 1-bit (``bin/pdf-to-imagestack:22-31``)
            tif_ok = True
            for pm in page_meta:
                depths = {x.get('depth') for x in
                          (pm.get('image_data') or [])}
                if depths - {1}:       # imageless pages don't veto TIFF
                    tif_ok = False
                    break
            args.format = 'tiff' if tif_ok else 'jp2'

    reader = PdfReader(args.infile)
    with zipfile.ZipFile(args.outzip, 'w', zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for idx in range(reader.page_count()):
            ppi = args.ppi
            if ppi is None and page_meta and idx < len(page_meta):
                try:
                    ppi = 72.0 * float(page_meta[idx]['estimated_scale'])
                except (KeyError, TypeError, ValueError):
                    ppi = None
            img = page_image(reader, idx, ppi=ppi)
            if img is None:
                print('page %d: could not render, skipped' % idx,
                      file=sys.stderr)
                continue
            fmt = args.format
            if fmt == 'auto':
                fmt = 'tiff' if img.mode == '1' else 'jp2'
            buf = io.BytesIO()
            if fmt == 'tiff':
                if img.mode != '1':
                    img = img.convert('1')
                img.save(buf, format='TIFF', compression='group4')
                ext = 'tif'
            else:
                if img.mode not in ('L', 'RGB'):
                    img = img.convert('RGB')
                img.save(buf, format='JPEG2000', quality_mode='rates',
                         quality_layers=[args.jp2_rate])
                ext = 'jp2'
            if args.identifier:
                member = '%s_%s/%s_%04d.%s' % (args.identifier, ext,
                                               args.identifier, idx, ext)
            else:
                member = 'page_%06d.%s' % (idx, ext)
            zf.writestr(member, buf.getvalue())
    print('wrote %s' % args.outzip)
    return 0


if __name__ == '__main__':
    sys.exit(main())
