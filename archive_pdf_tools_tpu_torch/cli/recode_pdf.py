"""recode_pdf_torch CLI: the JAX package's ``recode_pdf`` flags, driving
the PyTorch/CUDA port's ``recode``.

The parser and the per-codec default compression flags are the JAX
package's own (``build_parser``, ``resolve_compression_flags``; neither
imports jax).  ``--device`` picks the torch device (default the first
GPU; ``cpu`` runs the plain PyTorch versions of the kernels).  With
``--from-pdf`` and no ``--hocr-file``, the input's own text layer is
extracted as hOCR first.  Flags the port does not cover yet end the run
with an error naming the flag.
"""

import os
import shutil
import sys
import tempfile

from archive_pdf_tools_tpu.cli.recode_pdf import (build_parser,
                                                  resolve_compression_flags)
from archive_pdf_tools_tpu.const import COMPRESSOR_JBIG2


def _parser():
    parser = build_parser()
    parser.add_argument('--device', type=str, default='cuda:0',
                        help="torch device (default cuda:0; 'cpu' runs "
                             'the plain PyTorch versions of the kernels)')
    return parser


def main(argv=None):
    parser = _parser()
    args = parser.parse_args(argv)

    if (args.from_pdf is None and args.from_imagestack is None) \
            or args.out_pdf is None:
        sys.stderr.write('***** Error: --from-pdf or --out-pdf missing\n\n')
        parser.print_help()
        return 1
    if args.from_imagestack is not None and args.from_pdf is not None:
        sys.stderr.write('***** Error: --from-pdf and --from-imagestack '
                         'are mutually exclusive\n\n')
        parser.print_help()
        return 1
    auto_hocr_dir = None
    if args.hocr_file is None:
        # with --from-pdf, the input's own text layer, extracted as hOCR
        # by the shared pdf-to-hocr (no jax, no image decoding)
        if args.from_pdf is None:
            sys.stderr.write('***** Error: --hocr-file is required with '
                             '--from-imagestack\n\n')
            parser.print_help()
            return 1
        from archive_pdf_tools_tpu.cli.pdf_to_hocr import main as hocr_main
        auto_hocr_dir = tempfile.mkdtemp(prefix='recode_hocr')
        args.hocr_file = os.path.join(auto_hocr_dir, 'text.hocr')
        if args.verbose:
            print('No --hocr-file: extracting the text layer of %s'
                  % args.from_pdf)
        if hocr_main(['-f', args.from_pdf, '-o', args.hocr_file]):
            shutil.rmtree(auto_hocr_dir, ignore_errors=True)
            sys.stderr.write('***** Error: text-layer extraction failed\n')
            return 1

    args = resolve_compression_flags(args)
    try:
        res = _run_recode(args)
    finally:
        if auto_hocr_dir is not None:
            shutil.rmtree(auto_hocr_dir, ignore_errors=True)
    for error in res['errors']:
        print('Encountered runtime error:', error)
    return 0


def _run_recode(args):
    from ..pipeline.recode import recode
    return recode(
        from_pdf=args.from_pdf, from_imagestack=args.from_imagestack,
        dpi=args.dpi, hocr_file=args.hocr_file,
        scandata_file=args.scandata_file, out_pdf=args.out_pdf,
        out_dir=args.out_dir, reporter=args.reporter,
        grayscale_pdf=args.grayscale_pdf,
        force_1bit_output=args.bw_pdf,
        image_mode=args.image_mode,
        jbig2=args.mask_compression == COMPRESSOR_JBIG2,
        verbose=args.verbose, debug=args.debug, tmp_dir=args.tmp_dir,
        report_every=args.report_every, stop_after=args.stop_after,
        jpeg2000_implementation=args.jpeg2000_implementation,
        bg_compression_flags=args.bg_compression_flags.split(' '),
        fg_compression_flags=args.fg_compression_flags.split(' '),
        mrc_image_format=args.mrc_image_format,
        downsample=args.downsample,
        bg_downsample=args.bg_downsample,
        fg_downsample=args.fg_downsample,
        denoise_mask=args.denoise_mask,
        hq_pages=args.hq_pages,
        hq_bg_compression_flags=args.hq_bg_compression_flags.split(' '),
        hq_fg_compression_flags=args.hq_fg_compression_flags.split(' '),
        threads=args.threads,
        render_text_lines=args.render_text_lines,
        metadata_url=args.metadata_url,
        metadata_title=args.metadata_title,
        metadata_author=args.metadata_author,
        metadata_creator=args.metadata_creator,
        metadata_language=args.metadata_language,
        metadata_subject=args.metadata_subject,
        metadata_creatortool=args.metadata_creatortool,
        ignore_invalid_pagenumbers=args.ignore_invalid_pagenumbers,
        mask_compression=args.mask_compression,
        batch_pages=args.batch_pages,
        exact_denoise=not args.approx_denoise,
        resume=args.resume, profile_dir=args.profile,
        jbig2_symbol_mode=args.jbig2_symbol_coding != 'off',
        jbig2_bands=args.jbig2_bands, device=args.device)


if __name__ == '__main__':
    sys.exit(main())
