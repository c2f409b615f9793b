"""Explode an MRC PDF for visual inspection: each page's background,
foreground and mask become pages of their own.  The port of the root
tool ``tools/mrcview`` (host code only), with the same arguments.

    python -m archive_pdf_tools_tpu_torch.tools.mrcview IN.pdf OUT.pdf \\
        [--masks-only]
"""

import argparse
import sys

from ..pdf.reader import PdfReader
from ..pdf.rewrite import _convert
from ..pdf.writer import Name, PdfWriter, Stream


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('inpdf')
    parser.add_argument('outpdf')
    parser.add_argument('--masks-only', action='store_true',
                        help='maskview behaviour: one page per mask')
    args = parser.parse_args(argv)

    r = PdfReader(args.inpdf)
    w = PdfWriter()
    catalog_ref = w.reserve()
    pages_ref = w.reserve()
    page_refs = []

    def add_layer_page(xobj_stream, width, height, drop_smask=False):
        d = _convert(xobj_stream.dict)
        d.pop(Name('Length'), None)
        if drop_smask:
            d.pop(Name('SMask'), None)
        img_ref = w.add(Stream(d, xobj_stream.raw))
        ops = b'q %g 0 0 %g 0 0 cm /Im0 Do Q' % (width, height)
        content = w.add(Stream({}, ops, deflate=True))
        page_refs.append(w.add({
            Name('Type'): Name('Page'), Name('Parent'): pages_ref,
            Name('MediaBox'): [0, 0, width, height],
            Name('Contents'): content,
            Name('Resources'): {Name('XObject'): {Name('Im0'): img_ref}},
        }))

    for idx in range(r.page_count()):
        pw, ph = r.page_size(idx)
        for _name, _num, stream in r.page_images(idx):
            smask = r.resolve(stream.dict.get('SMask'))
            if args.masks_only:
                if smask is not None:
                    add_layer_page(smask, pw, ph)
                continue
            add_layer_page(stream, pw, ph, drop_smask=True)
            if smask is not None:
                add_layer_page(smask, pw, ph)

    w.set(pages_ref, {Name('Type'): Name('Pages'), Name('Kids'): page_refs,
                      Name('Count'): len(page_refs)})
    w.set(catalog_ref, {Name('Type'): Name('Catalog'),
                        Name('Pages'): pages_ref})
    with open(args.outpdf, 'wb') as fp:
        w.save(fp, catalog_ref)
    print('wrote %s (%d layer pages)' % (args.outpdf, len(page_refs)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
