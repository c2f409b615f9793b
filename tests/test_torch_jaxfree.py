"""The PyTorch port never imports jax, and its main path (hOCR lines,
layer downsampling, scandata, --from-pdf and -J tpu included) needs no
lxml (GPU machines may not ship it)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r'''
import os, pkgutil, importlib, sys
sys.path.insert(0, %(root)r)
import archive_pdf_tools_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]
for name in names:
    importlib.import_module(name)
for name in ('ops.lines_cuda', 'ops.paste_cuda', 'ops.resize',
             'ops.threshold_ablate_cuda', 'tools.threshold_ablate',
             'inputs.scandata', 'pdf.raster', 'ops.dwt97', 'ops.dwt97_cuda',
             'codecs.jp2host', 'codecs.jp2tpu', 'codecs.mrc_encode'):
    assert pkg.__name__ + '.' + name in names, name
print(len(names), 'jax' in sys.modules)
'''

_RECODE_WITHOUT_LXML = r'''
import sys
sys.modules['jax'] = None       # any import of jax or lxml now fails
sys.modules['lxml'] = None
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(2)
from PIL import Image
from fixtures import render_book_page, words_to_hocr_page, HOCR_TEMPLATE
from archive_pdf_tools_tpu.validators import validate_pdfa
from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
tmp = %(tmp)r
img, words = render_book_page(200, 260, seed=0, noise=0)
assert words
Image.fromarray(img).save(tmp + '/page_0000.png')
with open(tmp + '/book.hocr', 'w') as fp:
    fp.write(HOCR_TEMPLATE %% words_to_hocr_page(words, 200, 260, dpi=100))
rc = main(['--from-imagestack', tmp + '/page_*.png', '--hocr-file',
           tmp + '/book.hocr', '--dpi', '100', '-o', tmp + '/out.pdf',
           '--device', 'cpu', '--threads', '2', '--bg-downsample', '3']
          + %(extra)r)
validate_pdfa(tmp + '/out.pdf')
print('rc', rc)
'''


_FROM_PDF_WITHOUT_LXML = r'''
import pathlib, sys
sys.modules['jax'] = None       # any import of jax or lxml now fails
sys.modules['lxml'] = None
sys.path.insert(0, %(root)r)
sys.path.insert(0, %(tests)r)
import torch
torch.set_num_threads(2)
from PIL import Image
from fixtures import (render_book_page, words_to_hocr_page, HOCR_TEMPLATE,
                      make_scandata)
from archive_pdf_tools_tpu.pdf.reader import PdfReader
from archive_pdf_tools_tpu.validators import validate_pdfa
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
print('rc', rc)
'''


def _env():
    env = dict(os.environ, OMP_NUM_THREADS='2')
    env.pop('APT_PLATFORM', None)
    return env


def test_port_imports_no_jax():
    r = subprocess.run([sys.executable, '-c', _IMPORT_ALL % {'root': ROOT}],
                       capture_output=True, text=True, env=_env(),
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    n, has_jax = r.stdout.split()
    assert int(n) >= 18
    assert has_jax == 'False'


def _run_main_path(tmp_path, extra):
    code = _RECODE_WITHOUT_LXML % {'root': ROOT, 'tmp': str(tmp_path),
                                   'tests': os.path.join(ROOT, 'tests'),
                                   'extra': extra}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith('rc 0')


def test_main_path_runs_without_jax_and_lxml(tmp_path):
    _run_main_path(tmp_path, [])


def test_tpu_jpeg2000_runs_without_jax_and_lxml(tmp_path):
    """-J tpu: the port's transform and the copied host encoder."""
    _run_main_path(tmp_path, ['-J', 'tpu'])


def test_scandata_and_from_pdf_run_without_jax_and_lxml(tmp_path):
    code = _FROM_PDF_WITHOUT_LXML % {'root': ROOT, 'tmp': str(tmp_path),
                                     'tests': os.path.join(ROOT, 'tests')}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith('rc 0')
