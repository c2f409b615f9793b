"""Write the port's copies of the JAX package's jax-free modules.

The port imports nothing of ``archive_pdf_tools_tpu``: every module of it
that the port needs (PDF reading and writing, the host codecs, the
validators, the CLIs' text-layer extraction, the EPUB/XPS converter and
its font embedding) is kept here as a copy at the same relative path
under ``archive_pdf_tools_tpu_torch/``, so that its relative imports
resolve inside the port.  Each copy starts with a comment naming its
source and this script; the few edits are exact substitutions listed
below, each of which must match exactly once.  A copy that imports lxml
gets the port's ``utils/etree_compat.py`` in its place.  The files are
read as text; nothing of the JAX package is imported.

    python -m archive_pdf_tools_tpu_torch.tools.copy_shared          # write
    python -m archive_pdf_tools_tpu_torch.tools.copy_shared --check  # diff

Two modules of the port merge a shared module with the port's own code
and are kept by hand: ``codecs/mrc_encode.py`` and ``cli/recode_pdf.py``
(their headers name the copied parts).  Modules of the port's own that
hold a copied function (``REGIONS``) carry it between two marker lines,
``# copy_shared: <source>:<first>-<last>`` and ``# copy_shared: end``;
the script rewrites what lies between them.
"""

import os
import shutil
import sys

PORT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORT)
SOURCE = os.path.join(ROOT, 'archive_pdf_tools_tpu')

_JAX_ENGINE = ("PRODUCER = ('Internet Archive PDF (TPU) %s; jax/XLA MRC engine'\n"
               "            % (VERSION,))\n")
_PORT_BUILD = ("os.path.join(os.path.dirname(os.path.dirname(\n"
               "    os.path.abspath(__file__))), 'build', ")

# port path: (source path or (source path, first line, last line), why,
# [(old, new), ...])
COPIES = {
    'const.py': ('const.py', "the port's own PRODUCER", [
        (_JAX_ENGINE,
         "PRODUCER = ('Internet Archive PDF (PyTorch/CUDA) %s; torch MRC engine'\n"
         "            % (VERSION,))\n"
         "# the JAX package's engine name, which the XMP of a PDF it wrote\n"
         "# carries (pipeline/recode.py swaps it for PRODUCER)\n"
         + _JAX_ENGINE.replace('PRODUCER =', 'REFERENCE_PRODUCER =')
         .replace('            %', '                      %'))]),
    'pipeline/timing.py': ('pipeline/timing.py', None, []),
    'mrc/hocr_prep.py': ('mrc/hocr_prep.py', None, []),
    'ops/sigma_np.py': (('ops/golden.py', 1, 14), None, []),
    'pdf/writer.py': ('pdf/writer.py', None, []),
    'pdf/reader.py': ('pdf/reader.py', None, []),
    'pdf/crypt.py': ('pdf/crypt.py', None, []),
    'pdf/fonts.py': ('pdf/fonts.py', None, []),
    'pdf/glyphs.py': ('pdf/glyphs.py', None, []),
    'pdf/pagenumbers.py': ('pdf/pagenumbers.py', None, []),
    'pdf/textlayer.py': ('pdf/textlayer.py', None, []),
    'pdf/builder.py': ('pdf/builder.py', None, []),
    'pdf/raster.py': ('pdf/raster.py', None, []),
    'pdf/textextract.py': ('pdf/textextract.py', None, []),
    'codecs/ccitt.py': ('codecs/ccitt.py', None, []),
    'codecs/jbig2.py': ('codecs/jbig2.py', 'the .so goes to the port\'s '
                        'build/', [
                            ("_SO_PATH = os.path.join(_NATIVE_DIR, "
                             "'libjbig2tpu.so')",
                             "_SO_PATH = " + _PORT_BUILD
                             + "'libjbig2tpu.so')")]),
    'codecs/jpeg.py': ('codecs/jpeg.py', None, []),
    'codecs/jpeg2000.py': ('codecs/jpeg2000.py', "'tpu' names the port's "
                           "host coder", [
                               ('        from . import jp2tpu\n',
                                '        from . import jp2host as jp2tpu\n')]),
    'utils/nativebuild.py': ('utils/nativebuild.py', 'makes the .so\'s '
                             'directory', [
                                 ("    with _path_lock(so_path):\n",
                                  "    os.makedirs(os.path.dirname(so_path), "
                                  "exist_ok=True)\n"
                                  "    with _path_lock(so_path):\n")]),
    'pdf/rewrite.py': ('pdf/rewrite.py', None, []),
    'cli/pdf_to_hocr.py': ('cli/pdf_to_hocr.py', None, []),
    'cli/pdf_metadata_json.py': ('cli/pdf_metadata_json.py', None, []),
    'cli/compress_pdf_images.py': (
        'cli/compress_pdf_images.py', 'a --device for the MRC (default '
        'cuda:0), the mask fetched from the device', [
            ("                         hocr_dims=None, recompress_mrc=False):\n",
             "                         hocr_dims=None, recompress_mrc=False,\n"
             "                         device=None):\n"),
            ("            denoise_mask=DENOISE_FAST, errors=errors)\n",
             "            denoise_mask=DENOISE_FAST, device=device)\n"),
            ("            np.asarray(mask_dev)[0], fg[0], bg[0],\n",
             "            mask_dev[0].cpu().numpy(), fg[0], bg[0],\n"),
            ("    parser.add_argument('-v', '--verbose', action='store_true')\n"
             "    args = parser.parse_args(argv)\n",
             "    parser.add_argument('-v', '--verbose', action='store_true')\n"
             "    parser.add_argument('--device', default='cuda:0',\n"
             "                        help=\"torch device (default cuda:0; 'cpu' "
             "runs the \"\n"
             "                             'plain PyTorch versions of the "
             "kernels)')\n"
             "    args = parser.parse_args(argv)\n"
             "    from ..utils.backend import resolve_device\n"
             "    device = resolve_device(args.device)\n"),
            ("                                recompress_mrc=args.recompress_mrc):\n",
             "                                recompress_mrc=args.recompress_mrc,\n"
             "                                device=device):\n")]),
    'cli/pdfcomp.py': ('cli/pdfcomp.py', 'passes --device on to '
                       'compress-pdf-images', [
                           ("    parser.add_argument('--bg-downsample', type=int, "
                            "default=3)\n    args",
                            "    parser.add_argument('--bg-downsample', type=int, "
                            "default=3)\n"
                            "    parser.add_argument('--device', default='cuda:0',\n"
                            "                        help=\"torch device (default "
                            "cuda:0; 'cpu' runs the \"\n"
                            "                             'plain PyTorch versions "
                            "of the kernels)')\n    args"),
                           ("    cargv += [args.outfile, '--bg-downsample', "
                            "str(args.bg_downsample)]\n",
                            "    cargv += [args.outfile, '--bg-downsample', "
                            "str(args.bg_downsample),\n"
                            "              '--device', args.device]\n")]),
    'cli/pdf_to_imagestack.py': ('cli/pdf_to_imagestack.py', None, []),
    'cli/pdfrenderer_cli.py': ('cli/pdfrenderer_cli.py', None, []),
    'pdf/embedfont.py': ('pdf/embedfont.py', None, []),
    'cli/epub_to_pdf.py': ('cli/epub_to_pdf.py', "lxml is the port's "
                           "utils/etree_compat.py; a comment names no machine "
                           "path", [
                               ('from lxml import etree\n',
                                'from ..utils import etree_compat as etree\n'),
                               ('(/root/reference/bin/epub-to-pdf:52-60)',
                                "(the reference's bin/epub-to-pdf:52-60)")]),
    'inputs/hocr.py': ('inputs/hocr.py', "lxml is the port's "
                       'utils/etree_compat.py', [
                           ('from lxml import etree\n',
                            'from ..utils import etree_compat as etree\n')]),
    'inputs/scandata.py': ('inputs/scandata.py', "lxml is the port's "
                           'utils/etree_compat.py', [
                               ('from lxml import etree\n',
                                'from ..utils import etree_compat as etree\n')]),
    'validators/__init__.py': ('validators/__init__.py', None, []),
    'validators/jbig2_check.py': ('validators/jbig2_check.py', None, []),
    'validators/jp2_check.py': ('validators/jp2_check.py', None, []),
    'validators/jp2t1_check.py': ('validators/jp2t1_check.py', None, []),
    'validators/pdfa_check.py': ('validators/pdfa_check.py', 'the strict '
                                 "JPX check re-encodes with the port's "
                                 'host coder', [
                                     ('    from ..codecs import jp2tpu as '
                                      '_J\n',
                                      '    from ..codecs import jp2host as '
                                      '_J\n')]),
}

# ops/sigma_np.py: the rest of it, after the docstring and imports
SIGMA_BODY = ('ops/golden.py', 141, 190)

DATA = {'data/glyphless.ttf': 'data/glyphless.ttf'}

# port path: [(source path, first line, last line), ...], the copied
# regions of a module of the port's own, in file order
REGIONS = {
    'parallel/sharded.py': [('parallel/sharded.py', 148, 170)],
    'parallel/multihost.py': [('parallel/multihost.py', 41, 91)],
}
_END = '# copy_shared: end\n'


def _lines(rel, first=None, last=None):
    with open(os.path.join(SOURCE, rel), encoding='utf-8') as fp:
        text = fp.read()
    if first is None:
        return text
    return ''.join(text.splitlines(True)[first - 1:last])


def render(port_rel):
    """The text of the port's copy at ``port_rel``."""
    src, why, edits = COPIES[port_rel]
    if isinstance(src, tuple):
        rel, first, last = src
        body = _lines(*src) + '\n' + _lines(*SIGMA_BODY)
        where = '%s:%d-%d and :%d-%d' % (rel, first, last, SIGMA_BODY[1],
                                         SIGMA_BODY[2])
        why = 'estimate_sigma_np and its helpers only'
    else:
        body = _lines(src)
        where = src
    for old, new in edits:
        n = body.count(old)
        if n != 1:
            raise SystemExit('copy_shared: %s: edit matches %d times: %r'
                             % (port_rel, n, old))
        body = body.replace(old, new)
    head = ('# Copied from archive_pdf_tools_tpu/%s by\n'
            '# archive_pdf_tools_tpu_torch/tools/copy_shared.py; %s.\n'
            % (where, 'edit: ' + why if why else 'verbatim'))
    return head + body


def render_regions(port_rel, text):
    """``text``, the port's module at ``port_rel``, with each copied
    region as the source has it today."""
    for rel, first, last in REGIONS[port_rel]:
        begin = '# copy_shared: archive_pdf_tools_tpu/%s:%d-%d\n' % (
            rel, first, last)
        if text.count(begin) != 1:
            raise SystemExit('copy_shared: %s: marker %r found %d times'
                             % (port_rel, begin, text.count(begin)))
        a = text.index(begin) + len(begin)
        b = text.find(_END, a)
        if b < 0:
            raise SystemExit('copy_shared: %s: no end marker after %r'
                             % (port_rel, begin))
        text = text[:a] + _lines(rel, first, last) + text[b:]
    return text


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    check = '--check' in argv
    stale = []
    for port_rel in COPIES:
        text = render(port_rel)
        dst = os.path.join(PORT, port_rel)
        old = None
        if os.path.exists(dst):
            with open(dst, encoding='utf-8') as fp:
                old = fp.read()
        if old == text:
            continue
        stale.append(port_rel)
        if not check:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            with open(dst, 'w', encoding='utf-8') as fp:
                fp.write(text)
    for port_rel, src in DATA.items():
        dst = os.path.join(PORT, port_rel)
        with open(os.path.join(SOURCE, src), 'rb') as fp:
            data = fp.read()
        if os.path.exists(dst):
            with open(dst, 'rb') as fp:
                if fp.read() == data:
                    continue
        stale.append(port_rel)
        if not check:
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(os.path.join(SOURCE, src), dst)
    for port_rel in REGIONS:
        dst = os.path.join(PORT, port_rel)
        with open(dst, encoding='utf-8') as fp:
            old = fp.read()
        text = render_regions(port_rel, old)
        if text == old:
            continue
        stale.append(port_rel)
        if not check:
            with open(dst, 'w', encoding='utf-8') as fp:
                fp.write(text)
    for port_rel in stale:
        print(('stale: ' if check else 'wrote: ') + port_rel)
    return 1 if check and stale else 0


if __name__ == '__main__':
    sys.exit(main())
