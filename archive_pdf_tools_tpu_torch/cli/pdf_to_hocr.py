# Copied from archive_pdf_tools_tpu/cli/pdf_to_hocr.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""pdf-to-hocr: extract a PDF's text layer as hOCR.

The reference has no in-repo equivalent — its ``bin/pdfcomp`` shells
out to archive-hocr-tools' external ``pdf-to-hocr`` (``bin/pdfcomp:31``)
with the same ``-f infile -J pdfmeta.json`` surface, hOCR on stdout.
This in-tree version uses the content-stream glyph sink
(``pdf/textextract.py``), making the whole pdfcomp pipeline
self-contained.

Coordinates are emitted at each page's estimated render resolution
(``estimated_ppi`` from the ``-J`` metadata JSON when given, else
analysed on the fly, else ``--ppi``), i.e. the same raster space
``pdf-to-imagestack`` renders at.
"""

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Extract hOCR from a PDF text layer.')
    parser.add_argument('-f', '--infile', required=True)
    parser.add_argument('-J', '--json', default=None,
                        help='pdf-metadata-json report (for per-page '
                             'render resolution)')
    parser.add_argument('-o', '--outfile', default=None,
                        help='output path (default: stdout)')
    parser.add_argument('--ppi', type=float, default=None,
                        help='fixed output resolution (overrides -J)')
    args = parser.parse_args(argv)

    from ..pdf.reader import PdfReader
    from ..pdf.textextract import pdf_to_hocr

    reader = PdfReader(args.infile)

    scales = None
    default_scale = 1.0
    if args.ppi is not None:
        default_scale = args.ppi / 72.0
    else:
        meta = None
        if args.json:
            with open(args.json) as fp:
                meta = json.load(fp)
        else:
            from .pdf_metadata_json import analyse
            try:
                meta = analyse(args.infile)
            except Exception:
                meta = None
        if meta and isinstance(meta.get('page_data'), list):
            scales = [float(p.get('estimated_ppi') or 72) / 72.0
                      for p in meta['page_data']]

    if args.outfile:
        with open(args.outfile, 'wb') as fp:
            pdf_to_hocr(reader, fp, scales=scales,
                        default_scale=default_scale)
    else:
        out = getattr(sys.stdout, 'buffer', sys.stdout)
        pdf_to_hocr(reader, out, scales=scales,
                    default_scale=default_scale)
    return 0


if __name__ == '__main__':
    sys.exit(main())
