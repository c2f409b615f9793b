"""Size breakdown of a PDF into bg/fg/mask/rest percentages: the port of
the root tool ``tools/pdfimagesmrc`` (host code only), with the same
arguments.

    python -m archive_pdf_tools_tpu_torch.tools.pdfimagesmrc IN.pdf
"""

import argparse
import os
import sys

from ..pdf.reader import PdfReader


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('inpdf')
    args = parser.parse_args(argv)

    r = PdfReader(args.inpdf)
    total = os.path.getsize(args.inpdf)
    bg = fg = mask = 0
    for idx in range(r.page_count()):
        for _name, _num, stream in r.page_images(idx):
            smask = r.resolve(stream.dict.get('SMask'))
            if smask is not None:
                fg += len(stream.raw)
                mask += len(smask.raw)
            else:
                bg += len(stream.raw)
    rest = total - bg - fg - mask
    print('total: %d bytes over %d pages' % (total, r.page_count()))
    for label, size in (('bg', bg), ('fg', fg), ('mask', mask),
                        ('rest', rest)):
        print('  %-5s %10d bytes  %5.1f%%'
              % (label, size, 100.0 * size / max(total, 1)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
