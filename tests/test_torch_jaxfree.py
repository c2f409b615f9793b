"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package (``archive_pdf_tools_tpu``), and its main path (hOCR
lines, layer downsampling, scandata, --from-pdf and -J tpu included)
needs no lxml (GPU machines may not ship it), nor do the off-path
options, the compress-pdf-images, pdfcomp, pdf-to-imagestack,
pdfrenderer, pdf-metadata-json, pdf-to-hocr and epub-to-pdf tools, the
debug tools, and hOCR that is not well-formed.  The runs below block all
three imports, with ``APT_PLATFORM=cpu`` set as the JAX package's tools
set it."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = 'archive_pdf_tools_tpu_torch'
JAX_PKG = 'archive_pdf_tools_tpu'

# any import of jax, lxml or the JAX package now fails
_BLOCK = r'''
import sys
for _name in ('jax', 'lxml', 'archive_pdf_tools_tpu'):
    sys.modules[_name] = None
'''

# no module of the JAX package was imported (the blocks are None)
_NO_JAX_PKG = r'''
_jax_pkg = [k for k, v in sys.modules.items()
            if v is not None and k.split('.')[0] == 'archive_pdf_tools_tpu']
assert not _jax_pkg, _jax_pkg
'''

_IMPORT_ALL = _BLOCK + r'''
import os, pkgutil, importlib
sys.path.insert(0, %(root)r)
import archive_pdf_tools_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
for name in ('ops.lines_cuda', 'ops.paste_cuda', 'ops.resize',
             'ops.threshold_ablate_cuda', 'tools.threshold_ablate',
             'inputs.scandata', 'pdf.raster', 'ops.dwt97', 'ops.dwt97_cuda',
             'codecs.jp2host', 'codecs.jp2tpu', 'codecs.mrc_encode',
             'const', 'validators.pdfa_check', 'pdf.builder',
             'cli.pdf_to_hocr', 'utils.nativebuild', 'ops.grayconvert',
             'ops.tv', 'pdf.rewrite', 'cli.compress_pdf_images',
             'cli.pdfcomp', 'mrc.step', 'parallel.mesh', 'parallel.sharded',
             'parallel.multihost', 'ops.filters', 'tools.threshold_image',
             'tools.partial_blur', 'tools.compress', 'tools.mrcview',
             'tools.pdfimagesmrc', 'cli.pdf_to_imagestack',
             'cli.pdfrenderer_cli', 'utils.etree_compat', 'pdf.embedfont',
             'cli.epub_to_pdf', 'inputs.hocr', 'cli.pdf_metadata_json'):
    assert pkg.__name__ + '.' + name in names, name
''' + _NO_JAX_PKG + r'''
print(len(names), sys.modules['jax'] is not None)
'''

_RECODE_WITHOUT_LXML = _BLOCK + r'''
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(2)
from PIL import Image
from fixtures import render_book_page, words_to_hocr_page, HOCR_TEMPLATE
from archive_pdf_tools_tpu_torch.validators import validate_pdfa
from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
tmp = %(tmp)r
img, words = render_book_page(200, 260, seed=0, noise=0, rgb=%(rgb)r)
assert words
Image.fromarray(img).save(tmp + '/page_0000.png')
with open(tmp + '/book.hocr', 'w') as fp:
    fp.write(HOCR_TEMPLATE %% words_to_hocr_page(words, 200, 260, dpi=100))
rc = main(['--from-imagestack', tmp + '/page_*.png', '--hocr-file',
           tmp + '/book.hocr', '--dpi', '100', '-o', tmp + '/out.pdf',
           '--device', 'cpu', '--threads', '2', '--bg-downsample', '3']
          + %(extra)r)
validate_pdfa(tmp + '/out.pdf')
''' + _NO_JAX_PKG + r'''
print('rc', rc)
'''


_FROM_PDF_WITHOUT_LXML = _BLOCK + r'''
import pathlib
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(2)
from PIL import Image
from fixtures import (render_book_page, words_to_hocr_page, HOCR_TEMPLATE,
                      make_scandata)
from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
from archive_pdf_tools_tpu_torch.validators import validate_pdfa
from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
tmp = pathlib.Path(%(tmp)r)
hocr = []
for i in range(3):
    img, words = render_book_page(200, 260, seed=i, noise=0)
    Image.fromarray(img).save(str(tmp / ('page_%%04d.png' %% i)))
    hocr.append(words_to_hocr_page(words, 200, 260, page_no=i))
(tmp / 'book.hocr').write_text(HOCR_TEMPLATE %% '\n'.join(hocr))
sd = make_scandata(tmp, 3, dpi=100, skip=(2,), numbers=['1', '2', None])
common = ['--device', 'cpu', '--threads', '2']
rc = main(['--from-imagestack', str(tmp / 'page_*.png'), '--hocr-file',
           str(tmp / 'book.hocr'), '--scandata-file', sd,
           '-o', str(tmp / 'src.pdf')] + common)
assert rc == 0
validate_pdfa(str(tmp / 'src.pdf'))
src = PdfReader(str(tmp / 'src.pdf'))
assert src.page_count() == 2 and 'PageLabels' in src.catalog
assert all(len(src.page_images(i)) == 2 for i in range(2))
# the MRC output (two images and a text layer a page) as a source,
# without -T: hOCR from its text layer, each page rendered whole
rc = main(['--from-pdf', str(tmp / 'src.pdf'), '-o', str(tmp / 'out.pdf')]
          + common)
validate_pdfa(str(tmp / 'out.pdf'))
out = PdfReader(str(tmp / 'out.pdf'))
assert out.page_count() == 2
assert b'TJ' in out.page_contents(0)
''' + _NO_JAX_PKG + r'''
print('rc', rc)
'''


_CLI_TOOLS_WITHOUT_LXML = _BLOCK + r'''
import pathlib
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(2)
from PIL import Image
from fixtures import render_book_page, words_to_hocr_page, HOCR_TEMPLATE
from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
from archive_pdf_tools_tpu_torch.cli.recode_pdf import main as recode_main
from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import main as comp
from archive_pdf_tools_tpu_torch.cli.pdfcomp import main as pdfcomp
tmp = pathlib.Path(%(tmp)r)
hocr = []
for i in range(2):
    img, words = render_book_page(200, 260, seed=i, noise=0)
    Image.fromarray(img).save(str(tmp / ('page_%%04d.png' %% i)))
    hocr.append(words_to_hocr_page(words, 200, 260, page_no=i))
(tmp / 'book.hocr').write_text(HOCR_TEMPLATE %% '\n'.join(hocr))
# a source of JPEG images and a text layer
rc = recode_main(['--from-imagestack', str(tmp / 'page_*.png'),
                  '--hocr-file', str(tmp / 'book.hocr'), '--dpi', '100',
                  '--mrc-image-format', 'jpeg', '--mask-compression',
                  'ccitt', '-o', str(tmp / 'src.pdf'), '--device', 'cpu'])
assert rc == 0
src = str(tmp / 'src.pdf')
assert comp([src, str(tmp / 'book.hocr'), str(tmp / 'c.pdf'), '--dpi',
             '100', '--device', 'cpu']) == 0
# without --hocr: pdf-metadata-json and pdf-to-hocr first
assert pdfcomp([src, str(tmp / 'p.pdf'), '--device', 'cpu']) == 0
for out in ('c.pdf', 'p.pdf'):
    rd = PdfReader(str(tmp / out))
    assert rd.page_count() == 2
    assert 'MRCfg' in {n for n, _, _ in rd.page_images(0)}
''' + _NO_JAX_PKG + r'''
print('rc', rc)
'''


def _env():
    return dict(os.environ, OMP_NUM_THREADS='2', APT_PLATFORM='cpu')


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, '-c', _IMPORT_ALL % {'root': ROOT}],
                       capture_output=True, text=True, env=_env(),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    n, has_jax = r.stdout.split()
    assert int(n) >= 40
    assert has_jax == 'False'


def _imports(path):
    """Every module name an import statement of the file names."""
    with open(path, encoding='utf-8') as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ''


def test_no_import_of_the_jax_package_in_the_source():
    """No import statement of the port or of chip_smoke.py names the JAX
    package (strings naming its files, as in chip_smoke.py's kernel
    table, are fine)."""
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT, PORT)):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    assert len(files) > 40
    bad = [(os.path.relpath(f, ROOT), name) for f in files
           for name in _imports(f) if name.split('.')[0] == JAX_PKG]
    assert not bad


_CACHE_STATE = r'''
import os, pkgutil, importlib, sys
sys.path.insert(0, %(root)r)
tmp = '/tmp/jax_cache_apt'
def state():
    return (os.environ.get('JAX_COMPILATION_CACHE_DIR'),
            os.environ.get('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS'),
            os.path.lexists(tmp), os.path.islink(tmp),
            os.path.exists(os.path.join(%(root)r, '.jax_cache')))
before = state()
import archive_pdf_tools_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
assert state() == before, (before, state())
print('same')
'''


def test_port_import_leaves_the_jax_cache_alone():
    """The JAX package's import sets the JAX compile-cache variables and
    turns /tmp/jax_cache_apt into a link to <repo>/.jax_cache; importing
    the port touches none of them."""
    env = _env()
    env.pop('JAX_COMPILATION_CACHE_DIR', None)
    env.pop('JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS', None)
    r = subprocess.run([sys.executable, '-c', _CACHE_STATE % {'root': ROOT}],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == 'same'


def test_copies_of_the_jax_package_modules_are_current():
    """The port's copies (tools/copy_shared.py) equal what the script
    writes from the JAX package's sources today."""
    sys.path.insert(0, ROOT)
    from archive_pdf_tools_tpu_torch.tools import copy_shared
    assert copy_shared.main(['--check']) == 0


def _run_main_path(tmp_path, extra, rgb=False):
    code = _RECODE_WITHOUT_LXML % {'root': ROOT, 'tmp': str(tmp_path),
                                   'tests': os.path.join(ROOT, 'tests'),
                                   'extra': extra, 'rgb': rgb}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith('rc 0')


def test_main_path_runs_without_jax_and_lxml(tmp_path):
    _run_main_path(tmp_path, [])


def test_tpu_jpeg2000_runs_without_jax_and_lxml(tmp_path):
    """-J tpu: the port's transform and the copied host encoder."""
    _run_main_path(tmp_path, ['-J', 'tpu'])


def test_grayscale_and_bregman_run_without_jax_and_lxml(tmp_path):
    """--grayscale-pdf (an RGB page) with --denoise-mask bregman."""
    _run_main_path(tmp_path, ['--grayscale-pdf', '--denoise-mask',
                              'bregman'], rgb=True)


def test_compress_tools_run_without_jax_and_lxml(tmp_path):
    """compress-pdf-images, and pdfcomp with its text-layer extraction."""
    code = _CLI_TOOLS_WITHOUT_LXML % {'root': ROOT, 'tmp': str(tmp_path),
                                      'tests': os.path.join(ROOT, 'tests')}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith('rc 0')


_BLOCKED_RUN = _BLOCK + r'''
import runpy
sys.path.insert(0, %(root)r)
sys.argv = %(argv)r
try:
    if sys.argv[0].endswith('_torch'):
        runpy.run_path(sys.argv[0], run_name='__main__')
    else:
        runpy.run_module(sys.argv[0], run_name='__main__')
except SystemExit as exc:
    if exc.code:
        raise
''' + _NO_JAX_PKG


def _run_blocked(argv):
    """argv[0] (a bin/ script or a module of the port) run as __main__
    with jax, lxml and the JAX package blocked; it must exit 0 having
    imported nothing of the JAX package."""
    code = _BLOCKED_RUN % {'root': ROOT, 'argv': [str(a) for a in argv]}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_new_clis_and_tools_run_without_jax_and_lxml(tmp_path):
    """pdf-to-imagestack_torch and pdfrenderer_torch on a small book's
    PDF and hOCR, and the threshold-image tool on its first page."""
    sys.path.insert(0, os.path.join(ROOT, 'tests'))
    from fixtures import make_book
    from PIL import Image
    stack, hocr, pages = make_book(tmp_path, n_pages=2, w=200, h=260,
                                   dpi=100)
    pdf = tmp_path / 'text.pdf'
    _run_blocked([os.path.join(ROOT, 'bin', 'pdfrenderer_torch'), '-T',
                  hocr, '-o', pdf])
    assert pdf.stat().st_size > 0
    out = _run_blocked([os.path.join(ROOT, 'bin', 'pdf-to-imagestack_torch'),
                        pdf, tmp_path / 'stack.zip'])
    assert (tmp_path / 'stack.zip').stat().st_size > 0, out
    Image.fromarray(pages[0][0]).save(str(tmp_path / 'p0.png'))
    out = _run_blocked([PORT + '.tools.threshold_image', tmp_path / 'p0.png',
                        tmp_path / 'mask.png', '--dpi', '100', '--denoise',
                        'fast', '--device', 'cpu'])
    assert 'ink fraction' in out


def test_epub_to_pdf_runs_without_jax_and_lxml(tmp_path):
    """epub-to-pdf_torch on an EPUB whose chapters take the HTML parser
    and on an XPS with an embedded font: the JAX converter's bytes, with
    the port's own tree builder in place of lxml."""
    sys.path.insert(0, ROOT)
    from tests.test_torch_epub import JAX_SHA256, make_case, sha256_of
    for case in ('malformed', 'xps_font'):
        src = make_case(case, tmp_path)
        out = tmp_path / (case + '.pdf')
        _run_blocked([os.path.join(ROOT, 'bin', 'epub-to-pdf_torch'), src,
                      out])
        assert sha256_of(out) == JAX_SHA256[case]['full']


def test_scandata_and_from_pdf_run_without_jax_and_lxml(tmp_path):
    code = _FROM_PDF_WITHOUT_LXML % {'root': ROOT, 'tmp': str(tmp_path),
                                     'tests': os.path.join(ROOT, 'tests')}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith('rc 0')


def test_pyproject_names_every_package_of_the_port():
    """An installed port holds every subpackage, its kernel sources and
    the glyphless font its PDF builder embeds."""
    import tomllib
    with open(os.path.join(ROOT, 'pyproject.toml'), 'rb') as fp:
        tool = tomllib.load(fp)['tool']['setuptools']
    packages = set(tool['packages'])
    for dirpath, _dirs, names in os.walk(os.path.join(ROOT, PORT)):
        if '__init__.py' in names:
            rel = os.path.relpath(dirpath, ROOT).replace(os.sep, '.')
            assert rel in packages, rel
    data = tool['package-data'][PORT]
    assert 'csrc/*.cu' in data and 'data/*.ttf' in data
    assert 'csrc/*.cuh' in data           # headers the kernels include
    assert os.path.exists(os.path.join(ROOT, PORT, 'data', 'glyphless.ttf'))


def test_pyproject_names_every_entry_point_of_the_port():
    """Each of the port's scripts names a main of the port, and each has
    its bin/ launcher."""
    import importlib
    import tomllib
    with open(os.path.join(ROOT, 'pyproject.toml'), 'rb') as fp:
        scripts = tomllib.load(fp)['project']['scripts']
    ours = {k: v for k, v in scripts.items() if v.startswith(PORT + '.')}
    assert set(ours) == {'recode_pdf_torch', 'compress-pdf-images_torch',
                         'pdfcomp_torch', 'pdf-to-imagestack_torch',
                         'pdfrenderer_torch', 'epub-to-pdf_torch',
                         'pdf-metadata-json_torch'}
    sys.path.insert(0, ROOT)
    for name, target in ours.items():
        module, func = target.split(':')
        assert callable(getattr(importlib.import_module(module), func))
        assert os.access(os.path.join(ROOT, 'bin', name), os.X_OK)
    # the JAX package ships bin/pdf-to-hocr but no pdf-to-hocr script;
    # the port's launcher twins it, with no script either
    assert 'pdf-to-hocr' not in scripts and 'pdf-to-hocr_torch' not in scripts
    assert os.access(os.path.join(ROOT, 'bin', 'pdf-to-hocr_torch'), os.X_OK)


def test_metadata_and_hocr_launchers_run_without_jax_and_lxml(tmp_path):
    """bin/pdf-metadata-json_torch and bin/pdf-to-hocr_torch on a small
    PDF the port wrote: the JAX tools' JSON report and hOCR."""
    sys.path.insert(0, ROOT)
    import torch
    from archive_pdf_tools_tpu.cli.pdf_metadata_json import main as jax_meta
    from archive_pdf_tools_tpu.cli.pdf_to_hocr import main as jax_to_hocr
    from archive_pdf_tools_tpu_torch import recode
    from tests.fixtures import make_book
    torch.set_num_threads(2)
    stack, hocr, _ = make_book(tmp_path, n_pages=2, w=200, h=260, dpi=100)
    pdf = str(tmp_path / 'port.pdf')
    recode(from_imagestack=stack, hocr_file=hocr, out_pdf=pdf, dpi=100,
           device='cpu')
    bin_dir = os.path.join(ROOT, 'bin')
    _run_blocked([os.path.join(bin_dir, 'pdf-metadata-json_torch'), pdf,
                  tmp_path / 'port.json'])
    _run_blocked([os.path.join(bin_dir, 'pdf-to-hocr_torch'), '-f', pdf,
                  '-J', tmp_path / 'port.json', '-o', tmp_path / 'port.hocr'])
    assert jax_meta([pdf, str(tmp_path / 'jax.json')]) == 0
    assert jax_to_hocr(['-f', pdf, '-J', str(tmp_path / 'jax.json'), '-o',
                        str(tmp_path / 'jax.hocr')]) == 0
    for name in ('json', 'hocr'):
        ours = (tmp_path / ('port.' + name)).read_bytes()
        assert ours == (tmp_path / ('jax.' + name)).read_bytes(), name
    assert b'ocrx_word' in (tmp_path / 'port.hocr').read_bytes()


_C16_WITHOUT_LXML = _BLOCK + r'''
import io, pathlib
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(2)
from PIL import Image
import hocr_cases
from archive_pdf_tools_tpu_torch.inputs import hocr
from archive_pdf_tools_tpu_torch.pdf.textextract import pdf_to_hocr
from archive_pdf_tools_tpu_torch.validators import validate_pdfa
from archive_pdf_tools_tpu_torch.cli.recode_pdf import main as recode_main
from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import main as comp
from archive_pdf_tools_tpu_torch.cli.pdfrenderer_cli import main as render
tmp = pathlib.Path(%(tmp)r)
fx = hocr_cases._fixtures()
words = []
for i in range(3):
    img, wds = fx.render_book_page(320, 416, seed=i, rgb=i == 1, noise=0)
    Image.fromarray(img).save(str(tmp / ('page_%%04d.png' %% i)))
    words.append(wds)
(tmp / 'c16.hocr').write_bytes(hocr_cases.book_hocr(words))


def text_layer(pdf):
    buf = io.BytesIO()
    pdf_to_hocr(str(pdf), buf)
    return hocr_cases.words(hocr_cases.read(hocr, buf.getvalue()))


common = ['--device', 'cpu', '--dpi', '100']
assert recode_main(['--from-imagestack', str(tmp / 'page_*.png'),
                    '--hocr-file', str(tmp / 'c16.hocr'), '-o',
                    str(tmp / 'out.pdf')] + common) == 0
validate_pdfa(str(tmp / 'out.pdf'))
assert text_layer(tmp / 'out.pdf') == hocr_cases.PIN_WORDS['book']
assert comp([str(tmp / 'out.pdf'), str(tmp / 'c16.hocr'),
             str(tmp / 'comp.pdf'), '--recompress-mrc'] + common) == 0
assert render(['-T', str(tmp / 'c16.hocr'), '-o', str(tmp / 'text.pdf')]) == 0
assert text_layer(tmp / 'text.pdf') == hocr_cases.PIN_WORDS['book']
''' + _NO_JAX_PKG + r'''
print('rc', 0)
'''


def test_c16_hocr_runs_without_jax_and_lxml(tmp_path):
    """recode_pdf_torch --hocr-file, compress-pdf-images_torch and
    pdfrenderer_torch on hOCR with four of ROADMAP C16's faults (an
    undefined entity, a bare '&', an unclosed meta, the file cut inside
    its last page), lxml blocked: exit 0, and the words the JAX reader
    reads (tests/hocr_cases.py's pins) in the text layers."""
    code = _C16_WITHOUT_LXML % {'root': ROOT, 'tmp': str(tmp_path),
                                'tests': os.path.join(ROOT, 'tests')}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith('rc 0')
