# Copied from archive_pdf_tools_tpu/cli/pdfcomp.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: passes --device on to compress-pdf-images.
"""pdfcomp: one-shot 'compress this PDF' (``bin/pdfcomp``).

Pipeline parity: pdf-metadata-json -> pdf-to-hocr ->
compress-pdf-images, then print the compression factor
(``bin/pdfcomp:27-42``).  Unlike the reference, whose pdf-to-hocr step
is an external archive-hocr-tools tool (``bin/pdfcomp:31``), ours is
the in-tree extractor (``cli/pdf_to_hocr.py``), so the pipeline is
self-contained.
"""

import argparse
import os
import sys
import tempfile


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Compress a PDF with MRC, extracting hOCR if possible.')
    parser.add_argument('infile')
    parser.add_argument('outfile')
    parser.add_argument('--hocr', default=None,
                        help='use this hOCR instead of running pdf-to-hocr')
    parser.add_argument('--bg-downsample', type=int, default=3)
    parser.add_argument('--device', default='cuda:0',
                        help="torch device (default cuda:0; 'cpu' runs the "
                             'plain PyTorch versions of the kernels)')
    args = parser.parse_args(argv)

    from .pdf_metadata_json import analyse
    import json

    tmpdir = tempfile.mkdtemp(prefix='pdfcomp')
    meta_path = os.path.join(tmpdir, 'pdfmeta.json')
    with open(meta_path, 'w') as fp:
        json.dump(analyse(args.infile), fp)

    hocr_path = args.hocr
    if hocr_path is None:
        from .pdf_to_hocr import main as hocr_main
        hocr_path = os.path.join(tmpdir, 'out.hocr')
        rc = hocr_main(['-f', args.infile, '-J', meta_path,
                        '-o', hocr_path])
        if rc:
            hocr_path = None
            print('note: pdf-to-hocr failed; compressing without '
                  'text-guided masks', file=sys.stderr)

    from .compress_pdf_images import main as compress_main
    cargv = [args.infile]
    if hocr_path:
        cargv.append(hocr_path)
    cargv += [args.outfile, '--bg-downsample', str(args.bg_downsample),
              '--device', args.device]
    rc = compress_main(cargv)
    if rc:
        return rc

    oldsize = os.path.getsize(args.infile)
    newsize = os.path.getsize(args.outfile)
    print('Compression factor: %.2f' % (oldsize / max(newsize, 1)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
