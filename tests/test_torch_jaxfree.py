"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX package (``archive_pdf_tools_tpu``), and its main path (hOCR
lines, layer downsampling, scandata, --from-pdf and -J tpu included)
needs no lxml (GPU machines may not ship it), nor do the off-path
options and the compress-pdf-images and pdfcomp tools.  The runs below
block all three imports, with ``APT_PLATFORM=cpu`` set as the JAX
package's tools set it."""

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
             'cli.pdfcomp'):
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
                         'pdfcomp_torch'}
    sys.path.insert(0, ROOT)
    for name, target in ours.items():
        module, func = target.split(':')
        assert callable(getattr(importlib.import_module(module), func))
        assert os.access(os.path.join(ROOT, 'bin', name), os.X_OK)
