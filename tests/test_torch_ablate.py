"""The ablation builds of the blur + Sauvola kernel (K6): the plain
versions held against the JAX tool ``tools/threshold_ablate.py``.

The JAX tool has no ``interpret`` argument, so it runs here as the JAX
package's own tests run Pallas on the CPU: ``pallas_call`` is patched to
interpret mode (``_build`` looks it up at call time).  Two cases: a
small one with sigma 1.0 taps at radius 2, and real gaussian taps
(sigma 1.5) at the tool's radius 4.
"""

import ctypes
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu_torch.ops import threshold_ablate_cuda as A
from archive_pdf_tools_tpu_torch.utils import cudabuild

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (shape, window, radius, sigma)
CASES = {'small': ((2, 40, 70), 15, 2, 1.0),
         'r4': ((2, 48, 90), 31, 4, 1.5)}


def _inputs(case):
    (b, h, w), window, radius, sigma = CASES[case]
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    g = np.exp(-0.5 * (np.arange(-radius, radius + 1) / sigma) ** 2)
    taps = np.zeros((b, 2 * radius + 1), np.float32)
    taps[:] = (g / g.sum()).astype(np.float32)
    return img, taps, window, radius


@pytest.fixture(scope='module')
def jax_tool(tmp_path_factory):
    """tools/threshold_ablate.py loaded by path, with pallas_call in
    interpret mode and the compile cache it names kept in a temp dir."""
    from jax.experimental import pallas as pl
    mp = pytest.MonkeyPatch()
    mp.setenv('JAX_COMPILATION_CACHE_DIR',
              str(tmp_path_factory.mktemp('jax_cache')))
    mp.setattr(pl, 'pallas_call', functools.partial(pl.pallas_call,
                                                    interpret=True))
    spec = importlib.util.spec_from_file_location(
        'jax_threshold_ablate', os.path.join(ROOT, 'tools',
                                             'threshold_ablate.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield mod
    mp.undo()


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('variant', ['full', 'no_emit', 'no_hmac',
                                     'no_vmac', 'no_blur'])
def test_arithmetic_variant_matches_jax_tool(jax_tool, variant, case):
    """Bit-exact at the small case and wherever no float sum is involved
    (no_blur).  With real taps at radius 4 the JAX kernel folds mirrored
    taps into pairs, another f32 sum order than the port's, which may
    flip a truncation: there the bar is >= 0.9999 agreement (the K3 bar,
    tests/test_torch_ops.py); equal on these inputs."""
    img, taps, window, radius = _inputs(case)
    ref = np.asarray(jax_tool._build(variant)(img, taps, window, radius))
    got = A.blur_sauvola_ablate_plain(torch.from_numpy(img),
                                      torch.from_numpy(taps), window,
                                      variant)
    assert got.dtype == (torch.uint8 if variant == 'no_emit'
                         else torch.bool)
    got = got.numpy().astype(np.uint8)
    assert got.shape == ref.shape == img.shape
    if case == 'small' or variant == 'no_blur':
        np.testing.assert_array_equal(got, ref)
    else:
        assert (got == ref).mean() >= 0.9999
    if variant != 'no_emit':
        assert 0 < got.mean() < 1            # a mask with ink and paper


@pytest.mark.parametrize('variant', ['machinery', 'u8ring', 'passthru'])
def test_timing_variants_return_the_page(variant):
    """The timing-only variants are held to ``img``.  (The JAX tool's
    outputs for them are its padded input shifted by its out_specs index
    map, an artefact of the TPU grid, not a result, so they are not
    compared.)"""
    img, taps, window, _ = _inputs('small')
    t_img, t_taps = torch.from_numpy(img), torch.from_numpy(taps)
    got = A.blur_sauvola_ablate(t_img, t_taps, window, variant)
    assert got.dtype == torch.uint8
    assert torch.equal(got, t_img)
    assert got.data_ptr() != t_img.data_ptr()


@pytest.mark.parametrize('variant', A.VARIANTS)
def test_wrapper_runs_the_plain_version_on_cpu(variant):
    img, taps, window, _ = _inputs('small')
    t_img, t_taps = torch.from_numpy(img), torch.from_numpy(taps)
    before = sum(A.blur_sauvola_ablate.launches.values())
    got = A.blur_sauvola_ablate(t_img, t_taps, window, variant)
    ref = A.blur_sauvola_ablate_plain(t_img, t_taps, window, variant)
    assert torch.equal(got, ref)
    assert sum(A.blur_sauvola_ablate.launches.values()) == before


def test_full_variant_is_the_shipped_plain_version():
    from archive_pdf_tools_tpu_torch.ops.threshold_cuda import \
        blur_sauvola_plain
    img, taps, window, _ = _inputs('r4')
    t_img, t_taps = torch.from_numpy(img), torch.from_numpy(taps)
    assert torch.equal(A.blur_sauvola_ablate(t_img, t_taps, window, 'full'),
                       blur_sauvola_plain(t_img, t_taps, window))


def test_wrapper_rejects_unknown_variant_and_bad_input():
    img, taps, window, _ = _inputs('small')
    t_img, t_taps = torch.from_numpy(img), torch.from_numpy(taps)
    with pytest.raises(ValueError):
        A.blur_sauvola_ablate(t_img, t_taps, window, 'no_such')
    with pytest.raises(ValueError):
        A.blur_sauvola_ablate(t_img, t_taps, window + 1, 'full')


def test_cudabuild_variant_names_its_own_library(tmp_path, monkeypatch):
    """A build with defines goes to lib<name>.<variant>.so with the -D
    flags added; the default build keeps its name and flags (no nvcc: the
    build and the loader are stubbed)."""
    monkeypatch.setattr(cudabuild, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(cudabuild, '_libs', {})
    built = []

    def fake_build(key, src, path, flags):
        built.append((key, path, flags))
        open(path, 'wb').close()

    class FakeLib:
        def __getattr__(self, name):
            return ctypes.CFUNCTYPE(ctypes.c_int)()

    monkeypatch.setattr(cudabuild, '_build', fake_build)
    monkeypatch.setattr(cudabuild.ctypes, 'CDLL', lambda path: FakeLib())
    sigs = {'apt_blur_sauvola': []}
    cudabuild.load('blur_sauvola', sigs, variant='no_emit',
                   defines={'APT_ABLATE': 'APT_ABL_NO_EMIT'})
    cudabuild.load('blur_sauvola', sigs)
    cudabuild.load('blur_sauvola', sigs, variant='no_emit',
                   defines={'APT_ABLATE': 'APT_ABL_NO_EMIT'})   # cached
    assert [b[:2] for b in built] == [
        ('blur_sauvola.no_emit', str(tmp_path / 'libblur_sauvola.no_emit.so')),
        ('blur_sauvola', str(tmp_path / 'libblur_sauvola.so'))]
    assert built[0][2] == cudabuild.NVCC_FLAGS \
        + ['-DAPT_ABLATE=APT_ABL_NO_EMIT']
    assert built[1][2] == cudabuild.NVCC_FLAGS
    assert cudabuild.so_path('paste') == str(tmp_path / 'libpaste.so')
    with pytest.raises(ValueError):
        cudabuild.load('blur_sauvola', sigs, defines={'X': '1'})


def test_ablation_source_guards_every_variant():
    """Each variant name has its define in the source, and the tool's
    entry point refuses to run without a GPU."""
    with open(os.path.join(cudabuild.CSRC, 'blur_sauvola.cu')) as fp:
        src = fp.read()
    for v in A.VARIANTS:
        assert '#define APT_ABL_%s ' % v.upper() in src
    if not torch.cuda.is_available():
        from archive_pdf_tools_tpu_torch.tools import threshold_ablate
        assert threshold_ablate.main(['1', '1']) != 0
