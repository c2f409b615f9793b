"""recode_pdf_torch CLI: the JAX package's ``recode_pdf`` flags, driving
the PyTorch/CUDA port's ``recode``.

The parser and the per-codec default compression flags are copies of the
JAX package's (``cli/recode_pdf.py:9-191``: ``build_parser``,
``resolve_compression_flags``), kept by hand.  ``--device`` picks the
torch device (default the first GPU, with each batch split over every
visible GPU when there are several; ``cpu`` runs the plain PyTorch
versions of the kernels).  With ``--from-pdf`` and no ``--hocr-file``,
the input's own text layer is extracted as hOCR first.  Every flag of
the JAX package's ``recode_pdf`` runs; ``--profile DIR`` writes a
torch.profiler Chrome trace, ``DIR/trace.json``, that holds every
thread's spans (main thread, page loader, encode pool).
"""

import argparse
import os
import shutil
import sys
import tempfile
from shutil import which

from ..const import (VERSION, IMAGE_MODE_MRC, IMAGE_MODE_SKIP,
                     JPEG2000_IMPL_KAKADU, JPEG2000_IMPL_OPENJPEG,
                     JPEG2000_IMPL_GROK, JPEG2000_IMPL_PILLOW,
                     JPEG2000_IMPL_TPU,
                     COMPRESSOR_JPEG2000, COMPRESSOR_JPEG, COMPRESSOR_JBIG2,
                     COMPRESSOR_CCITT, DENOISE_NONE, DENOISE_FAST,
                     DENOISE_BREGMAN)

# impl -> (bg, fg, hq_bg, hq_fg)   (bin/recode_pdf:204-287); the
# tables live with the codec facade so recode()'s API defaulting
# shares them
from ..codecs.jpeg2000 import (DEFAULT_COMPRESSION_FLAGS as
                               _J2K_DEFAULTS,
                               DEFAULT_JPEG_FLAGS as _JPEG_DEFAULTS)

_J2K_BINARIES = {
    JPEG2000_IMPL_KAKADU: ('kdu_compress', 'kdu_expand'),
    JPEG2000_IMPL_OPENJPEG: ('opj_compress', 'opj_decompress'),
    JPEG2000_IMPL_GROK: ('grk_compress', 'grk_decompress'),
}


def build_parser():
    parser = argparse.ArgumentParser(
        description='PDF recoder (TPU) version %s. Compresses PDFs with '
                    'images and inserts text layers based on hOCR input '
                    'files.' % VERSION)
    parser.add_argument('--version', action='version',
                        version='archive-pdf-tools-tpu {v}'.format(v=VERSION))

    inp = parser.add_argument_group('Input/output')
    inp.add_argument('-P', '--from-pdf', type=str, default=None,
                     help='Input PDF (containing images) to recode')
    inp.add_argument('-I', '--from-imagestack', type=str, default=None,
                     help='Glob pattern for image stack')
    inp.add_argument('-T', '--hocr-file', type=str, default=None,
                     help='hOCR file containing page information')
    inp.add_argument('-S', '--scandata-file', type=str, default=None,
                     help='archive.org scandata.xml: page skips, labels, '
                          'DPI, table of contents')
    inp.add_argument('-o', '--out-pdf', type=str, default=None,
                     help='Output file to write recoded PDF to')
    inp.add_argument('-O', '--out-dir', type=str, default=None,
                     help='Output directory to (also) write images to')

    misc = parser.add_argument_group('Miscellaneous')
    misc.add_argument('--threads', type=int, default=None,
                      help='Host encoder thread count (default 4)')
    misc.add_argument('-R', '--reporter', type=str, default=None,
                      help='Program to launch when reporting progress')
    misc.add_argument('--grayscale-pdf', action='store_true', default=False,
                      help='Convert all images to grayscale')
    misc.add_argument('--bw-pdf', action='store_true', default=False,
                      help='Convert all images to 1-bit')
    misc.add_argument('-v', '--verbose', action='store_true', default=False)
    misc.add_argument('--debug', action='store_true', default=False)
    misc.add_argument('--tmp-dir', type=str, default=None,
                      help='Directory for temporary intermediate images')
    misc.add_argument('--report-every', type=int, default=None,
                      help='Report status every N pages')
    misc.add_argument('-t', '--stop-after', type=int, default=None,
                      help='Stop after N pages')
    misc.add_argument('--render-text-lines', action='store_true',
                      default=False,
                      help='Render the text visibly instead of invisibly')
    misc.add_argument('--batch-pages', type=int, default=8,
                      help='TPU page batch size (default 8)')
    misc.add_argument('--approx-denoise', action='store_true', default=False,
                      help='Use the faster one-pass despeckle instead of '
                           'the bit-exact sequential-equivalent kernel')
    misc.add_argument('--jbig2-symbol-coding', default='off',
                      choices=('off', 'on', 'auto', 'lossy', 'refine'),
                      help='JBIG2 symbol-dictionary mask coding (beyond '
                           'the reference, which always emits a plain '
                           'generic region). on = lossless exact-match '
                           'classes; auto picks the smaller encoding per '
                           'page; lossy = correlation-classified glyph '
                           'classes (jbig2enc -s default behaviour); '
                           'refine = lossy classes made lossless again '
                           'by an XOR-composited generic residue region '
                           '(NOT T.88 refinement coding: SDREFAGG/'
                           'TPGRON streams cannot be verified without '
                           'the spec or an external decoder, so this '
                           'tool deliberately does not emit them; the '
                           'XOR residue achieves the same lossless-'
                           'with-shared-exemplars result with fully '
                           'verified machinery)')
    misc.add_argument('--jbig2-bands', type=int, default=1,
                      help='Code each JBIG2 mask as N independent '
                           'horizontal region segments encoded on a '
                           'thread pool (generic mode only; the MQ '
                           'coder is serial per region, so banding is '
                           'how one mask uses multiple host cores)')
    misc.add_argument('--resume', action='store_true', default=False,
                      help='Reuse per-page artifacts already present in '
                           '--out-dir (checkpoint/resume)')
    misc.add_argument('--profile', type=str, default=None, metavar='DIR',
                      help='Write a torch.profiler trace of the '
                           'compression pass to DIR/trace.json, with '
                           'every thread\'s spans (main thread, page '
                           'loader, encode pool)')

    comp = parser.add_argument_group('Compression')
    comp.add_argument('-m', '--image-mode', type=int, default=IMAGE_MODE_MRC,
                      help='0 pass-through, 1 pixmap, 2 MRC (default), '
                           '3 skip images')
    comp.add_argument('--mask-compression', type=str,
                      choices=[COMPRESSOR_JBIG2, COMPRESSOR_CCITT],
                      default=COMPRESSOR_JBIG2,
                      help='Mask (lossless) compression')
    comp.add_argument('-J', '--jpeg2000-implementation', type=str,
                      default=JPEG2000_IMPL_PILLOW,
                      choices=[JPEG2000_IMPL_KAKADU, JPEG2000_IMPL_OPENJPEG,
                               JPEG2000_IMPL_GROK, JPEG2000_IMPL_PILLOW,
                               JPEG2000_IMPL_TPU])
    comp.add_argument('--bg-compression-flags', type=str, default=None)
    comp.add_argument('--fg-compression-flags', type=str, default=None)
    comp.add_argument('--mrc-image-format', type=str,
                      default=COMPRESSOR_JPEG2000,
                      choices=[COMPRESSOR_JPEG2000, COMPRESSOR_JPEG])
    comp.add_argument('--hq-pages', type=str, default=None,
                      help="Comma-separated page list (negative indexes "
                           "allowed) rendered in higher quality, e.g. "
                           "'1,2,3,-2,-1'")
    comp.add_argument('--hq-bg-compression-flags', type=str, default=None)
    comp.add_argument('--hq-fg-compression-flags', type=str, default=None)

    img = parser.add_argument_group('Image')
    img.add_argument('-D', '--dpi', type=int, default=None,
                     help='DPI of input images')
    img.add_argument('--denoise-mask', type=str, default=DENOISE_FAST,
                     choices=[DENOISE_NONE, DENOISE_FAST, DENOISE_BREGMAN])
    img.add_argument('--downsample', type=int, default=None,
                     help='Downsample entire image by factor')
    img.add_argument('--bg-downsample', type=int, default=None)
    img.add_argument('--fg-downsample', type=int, default=None)

    meta = parser.add_argument_group('Metadata')
    meta.add_argument('--metadata-url', type=str, default=None)
    meta.add_argument('--metadata-title', type=str, default=None)
    meta.add_argument('--metadata-author', type=str, default=None)
    meta.add_argument('--metadata-creator', type=str, default=None)
    meta.add_argument('--metadata-language', type=str, default=None,
                      nargs='+', action='extend')
    meta.add_argument('--metadata-subject', type=str, default=None)
    meta.add_argument('--metadata-creatortool', type=str, default=None)
    meta.add_argument('--ignore-invalid-pagenumbers', action='store_true')
    return parser


def resolve_compression_flags(args):
    """Per-codec default flags (``bin/recode_pdf:204-298``)."""
    if args.image_mode == IMAGE_MODE_MRC:
        if args.mrc_image_format == COMPRESSOR_JPEG2000:
            bg, fg, hq_bg, hq_fg = _J2K_DEFAULTS[args.jpeg2000_implementation]
            bins = _J2K_BINARIES.get(args.jpeg2000_implementation)
            if bins and not all(which(b) for b in bins):
                sys.stderr.write(
                    '***** Error: %s requested but %s not found in $PATH\n'
                    % (args.jpeg2000_implementation, ' and '.join(bins)))
                sys.exit(1)
        elif args.mrc_image_format == COMPRESSOR_JPEG:
            bg, fg, hq_bg, hq_fg = _JPEG_DEFAULTS
        else:
            raise Exception('Invalid mrc image format')
        args.bg_compression_flags = args.bg_compression_flags or bg
        args.fg_compression_flags = args.fg_compression_flags or fg
        args.hq_bg_compression_flags = args.hq_bg_compression_flags or hq_bg
        args.hq_fg_compression_flags = args.hq_fg_compression_flags or hq_fg
    elif args.image_mode == IMAGE_MODE_SKIP:
        args.bg_compression_flags = ''
        args.fg_compression_flags = ''
        args.hq_bg_compression_flags = ''
        args.hq_fg_compression_flags = ''
    else:
        for attr in ('bg_compression_flags', 'fg_compression_flags',
                     'hq_bg_compression_flags', 'hq_fg_compression_flags'):
            if getattr(args, attr) is None:
                setattr(args, attr, '')
    return args



# the port's own from here on


def _parser():
    parser = build_parser()
    parser.add_argument('--device', type=str, default=None,
                        help='torch device (default: the first GPU, each '
                             "batch's pages split over every visible GPU "
                             'when there are several; a named device, e.g. '
                             "cuda:1, runs alone; 'cpu' runs the plain "
                             'PyTorch versions of the kernels)')
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
        # by pdf-to-hocr (no image decoding)
        if args.from_pdf is None:
            sys.stderr.write('***** Error: --hocr-file is required with '
                             '--from-imagestack\n\n')
            parser.print_help()
            return 1
        from .pdf_to_hocr import main as hocr_main
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
        jbig2_symbol_mode={'off': False, 'on': True, 'auto': 'auto',
                           'lossy': 'lossy',
                           'refine': 'refine'}[args.jbig2_symbol_coding],
        jbig2_bands=args.jbig2_bands, device=args.device)


if __name__ == '__main__':
    sys.exit(main())
