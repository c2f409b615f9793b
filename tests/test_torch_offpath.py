"""The port's off-path device ops and reference API wrappers held against
the JAX package: ``special_gray_convert`` (``--grayscale-pdf``),
``fast_mask_denoise_jacobi`` (``--approx-denoise``), the split-Bregman
TV denoise (``--denoise-mask bregman``), and ``decompose_pages`` /
``create_mrc_hocr_components``.

The gray conversion and the one-pass despeckle are exact arithmetic and
must equal the JAX functions bit for bit.  The TV loop amplifies a
one-ulp difference to tenths within its 100 iterations; the port takes
the roundings XLA compiles for the CPU, so it is held to 1e-4 (and
equals the JAX function here)."""

import numpy as np
import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.mrc import api as JA
from archive_pdf_tools_tpu.ops import golden
from archive_pdf_tools_tpu.ops.denoise import (
    fast_mask_denoise_jacobi as jax_jacobi)
from archive_pdf_tools_tpu.ops.grayconvert import (
    special_gray_convert as jax_gray)
from archive_pdf_tools_tpu.ops.tv import (
    denoise_bregman as jax_bregman, denoise_tv_bregman as jax_tv)

from archive_pdf_tools_tpu_torch.mrc import api as TA
from archive_pdf_tools_tpu_torch.mrc import decompose as TD
from archive_pdf_tools_tpu_torch.ops.denoise import fast_mask_denoise_jacobi
from archive_pdf_tools_tpu_torch.ops.grayconvert import special_gray_convert
from archive_pdf_tools_tpu_torch.ops.tv import (denoise_bregman,
                                                denoise_tv_bregman)

from tests.scanfix import synth_scan
from tests.test_kernels import synth_page
from tests.test_ops2 import _gray_ref

torch.set_num_threads(2)


def _keys(timing):
    """Stage keys in order, less the JAX package's noise-estimate key
    (``est_1``), which the port folds into ``threshold``."""
    return [k for k, _ in timing if k != 'est_1']


def _sepia(seed, h=160, w=120, noise=9.0):
    page, _ = synth_scan(h=h, w=w, seed=seed, dpi=150, noise_sigma=noise)
    f = np.random.default_rng(seed).uniform(0.7, 1.0, 3)
    return np.stack([(page * c).astype(np.uint8) for c in f], -1)


def _gray_cases():
    rng = np.random.default_rng(3)
    yield 'test_ops2 image', rng.integers(0, 256, (1, 64, 80, 3),
                                         dtype=np.uint8)
    yield 'sepia batch', np.stack([_sepia(s) for s in (1, 2, 3)])
    yield 'noise-free sepia', _sepia(4, noise=0.0)[None]
    flat = np.full((1, 20, 30, 3), 200, np.uint8)
    flat[0, 5:9, 4:20] = (30, 60, 90)
    yield 'two colours', flat


@pytest.mark.parametrize('name,img', list(_gray_cases()))
def test_special_gray_convert_equals_jax(name, img):
    got = special_gray_convert(torch.from_numpy(img))
    assert got.dtype == torch.uint8 and got.shape == img.shape[:3]
    assert (got.numpy() == np.asarray(jax_gray(img))).all(), name


def test_special_gray_convert_meets_the_reference_bar():
    """``tests/test_ops2.py``'s bar against the f64 numpy reference."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    ref = _gray_ref(img)
    got = special_gray_convert(torch.from_numpy(img[None]))[0].numpy()
    assert (ref == got).mean() > 0.9
    assert np.abs(ref.astype(int) - got.astype(int)).max() <= 1


def test_special_gray_convert_refuses_gray():
    with pytest.raises(TypeError):
        special_gray_convert(torch.zeros((1, 4, 4), dtype=torch.uint8))


@pytest.mark.parametrize('shape,ink', [((2, 37, 51), 0.3), ((1, 5, 5), 0.5),
                                       ((1, 3, 9), 0.6), ((3, 64, 65), 0.05)])
def test_jacobi_equals_jax(shape, ink):
    mask = np.random.default_rng(shape[1]).random(shape) < ink
    got = fast_mask_denoise_jacobi(torch.from_numpy(mask), 4, 2).numpy()
    assert (got == np.asarray(jax_jacobi(mask, 4, 2))).all()


def test_jacobi_close_to_golden():
    """``tests/test_kernels.py``'s bar for the one-pass despeckle."""
    img = synth_page(100, 140, seed=6)
    mask = golden.sauvola_mask_ref(img, 15, 15, 0.34)
    ref = golden.fast_mask_denoise_ref(mask, 4, 2)
    got = fast_mask_denoise_jacobi(torch.from_numpy(mask[None]), 4, 2)
    assert (ref == got[0].numpy()).mean() > 0.995


def _tv_noisy():
    rng = np.random.default_rng(5)
    clean = np.zeros((64, 64), np.float32)
    clean[20:44, 20:44] = 1.0
    return clean, clean + rng.normal(0, 0.3, clean.shape).astype(np.float32)


def test_tv_bregman_equals_jax_and_denoises():
    clean, noisy = _tv_noisy()
    got = denoise_tv_bregman(torch.from_numpy(noisy[None]), weight=1.0)
    got = got.numpy()[0]
    ref = np.asarray(jax_tv(noisy[None], weight=1.0))[0]
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-4
    assert ((got > 0.4) == (ref > 0.4)).mean() >= 0.9999
    # tests/test_ops2.py TestTV.test_denoises
    assert ((got > 0.5) == (clean > 0.5)).mean() > 0.97


@pytest.mark.parametrize('shape', [(1, 64, 64), (2, 40, 70)])
def test_bregman_mask_equals_jax(shape):
    """tests/test_ops2.py TestTV.test_mask_wrapper, and the JAX mask."""
    rng = np.random.default_rng(6)
    mask = np.zeros(shape, bool)
    mask[:, 10:30, 10:50] = True
    mask |= rng.random(shape) < 0.01
    got = denoise_bregman(torch.from_numpy(mask)).numpy()
    assert got.dtype == bool
    assert got[:, 15:25, 15:45].all()
    assert (got == np.asarray(jax_bregman(mask))).mean() >= 0.9999


@pytest.mark.parametrize('mode,exact', [('fast', True), ('fast', False),
                                        ('bregman', True), ('none', True)])
def test_denoise_dispatch_equals_jax(mode, exact):
    """``mrc/decompose.denoise_mask``: fast + exact is K2's plain version,
    fast + not exact the one-pass despeckle, bregman the TV denoise."""
    from archive_pdf_tools_tpu.mrc import decompose as JD
    mask = np.random.default_rng(7).random((1, 48, 56)) < 0.2
    got = TD.denoise_mask(torch.from_numpy(mask), mode, exact).numpy()
    assert (got == np.asarray(JD.denoise_mask(mask, mode, exact))).all()


def _pages(rgb, n=2):
    pages, wds = [], []
    for s in range(n):
        page, wd = synth_scan(h=240, w=300, seed=s + 1, dpi=150,
                              noise_sigma=0)
        pages.append(np.stack([page, page, np.clip(page.astype(int) - 9, 0,
                                                   255).astype(np.uint8)],
                              -1) if rgb else page)
        wds.append(wd)
    return pages, wds


@pytest.mark.parametrize('rgb,kw', [(False, {}), (True, {}),
                                    (False, {'denoise_mask': 'bregman'}),
                                    (True, {'bg_downsample': 3})])
def test_decompose_pages_equals_jax(rgb, kw):
    """Masks equal; layers equal where no resize enters, else their
    sizes."""
    pages, wds = _pages(rgb)
    tm, tf, tb = TA.decompose_pages(pages, wds, dpi=150, device='cpu', **kw)
    jm, jf, jb = JA.decompose_pages(pages, wds, dpi=150, **kw)
    assert isinstance(tm, np.ndarray) and tm.dtype == bool
    assert (tm == jm).all()
    assert (tf == np.asarray(jf)).all()
    if 'bg_downsample' in kw:
        assert tb.shape == np.asarray(jb).shape
    else:
        assert (tb == np.asarray(jb)).all()


@pytest.mark.parametrize('mode,denoise', [('L', None), ('RGB', 'fast'),
                                          ('P', 'fast')])
def test_create_mrc_hocr_components_equals_jax(mode, denoise):
    pages, wds = _pages(True, n=1)
    image = Image.fromarray(pages[0])
    if mode == 'L':
        image = image.convert('L')
    elif mode == 'P':
        image = image.convert('P')
    timing_t, timing_j = [], []
    got = list(TA.create_mrc_hocr_components(
        image, wds[0], dpi=150, denoise_mask=denoise, timing_data=timing_t,
        device='cpu'))
    ref = list(JA.create_mrc_hocr_components(
        image, wds[0], dpi=150, denoise_mask=denoise, timing_data=timing_j))
    assert len(got) == 3
    for a, b in zip(got, ref):
        assert isinstance(a, np.ndarray)
        assert (a == np.asarray(b)).all()
    assert _keys(timing_t) == _keys(timing_j)


@pytest.mark.parametrize('mode,key', [('fast', 'fast_denoise'),
                                      ('bregman', 'denoise')])
def test_denoise_timing_key(mode, key):
    """A bregman run is timed as ``denoise``, as in the JAX package."""
    pages, wds = _pages(False, n=1)
    timing_t, timing_j = [], []
    TA.decompose_masks(pages, wds, dpi=150, denoise_mask=mode,
                       timing_data=timing_t, device='cpu')
    JA.decompose_masks(pages, wds, dpi=150, denoise_mask=mode,
                       timing_data=timing_j)
    assert _keys(timing_t) == _keys(timing_j)
    assert timing_t[-1][0] == key


def test_decompose_masks_takes_a_device_tensor():
    """The gray conversion feeds the MRC without a host round trip."""
    pages, wds = _pages(True, n=2)
    gray = special_gray_convert(torch.from_numpy(np.stack(pages)))
    tm, dev = TA.decompose_masks(gray, wds, dpi=150, device='cpu')
    assert dev.shape == gray.shape
    ref, _ = TA.decompose_masks(list(gray.numpy()), wds, dpi=150,
                                device='cpu')
    assert (tm == ref).all()
