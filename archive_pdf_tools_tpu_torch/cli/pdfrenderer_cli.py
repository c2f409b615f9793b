# Copied from archive_pdf_tools_tpu/cli/pdfrenderer_cli.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""pdfrenderer: standalone hOCR -> text-only PDF (``bin/pdfrenderer``)."""

import argparse
import sys

from ..pdf.builder import DocumentBuilder


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Render an hOCR file to a text-only PDF '
                    '(invisible glyphless text layer, no images).')
    parser.add_argument('-T', '--hocr-file', required=True)
    parser.add_argument('-o', '--out-pdf', required=True)
    parser.add_argument('-D', '--dpi', type=int, default=None)
    parser.add_argument('--render-text-lines', action='store_true')
    args = parser.parse_args(argv)

    builder = DocumentBuilder(render_text_lines=args.render_text_lines)
    errors = set()

    # no images: page geometry comes from the hOCR page dims + dpi
    from ..inputs.hocr import (hocr_page_iterator, hocr_page_to_word_data,
                               hocr_page_get_dimensions,
                               hocr_page_get_scan_res)
    for hocr_page in hocr_page_iterator(args.hocr_file):
        w, h = hocr_page_get_dimensions(hocr_page)
        hocr_dpi = hocr_page_get_scan_res(hocr_page)[1]
        dpi = args.dpi or hocr_dpi or 72
        scaler = 72.0 / dpi
        width, height = w * scaler, h * scaler
        ppi = float(dpi)
        font_scaler = (hocr_dpi / ppi) if hocr_dpi else (72.0 / ppi)
        word_data = hocr_page_to_word_data(hocr_page, font_scaler)
        builder.add_text_page(word_data, width, height, ppi=ppi,
                              hocr_ppi=hocr_dpi)

    builder.write_metadata()
    builder.save(args.out_pdf)
    print('wrote %s (%d pages)' % (args.out_pdf, len(builder.pages)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
