"""The port's separable filters (``ops/filters.py``, torch ops) held
against the JAX package's (XLA ops) on the cases of
``tests/test_ops2.py``, edge pixels included: the symmetric border pad
repeats the edge sample as scipy's 'reflect' does, which torch's own
'reflect' pad does not.

The blurs are float sums in another order than XLA's convolution, so
the filters are held to the JAX tests' own bar against scipy (0.05),
and the partial blurs, which truncate those sums to uint8, to equal
bytes on >= 99.9% of the pixels and within 1 on the rest; the mask's
pixels are the image's, exactly.
"""

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu.ops import filters as JF

from archive_pdf_tools_tpu_torch.ops import filters as TF

from tests.test_kernels import synth_page

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('sigma', [0.5, 1.3, 3.0])
def test_gaussian_filter_matches_jax(sigma):
    img = synth_page(80, 100).astype(np.float32)
    ref = np.asarray(JF.gaussian_filter(img[None], sigma))[0]
    got = TF.gaussian_filter(_t(img[None]), sigma).numpy()[0]
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(ref - got).max() < 0.05
    # the border rows and columns, where the pad is read
    r = int(4.0 * sigma + 0.5)
    for edge in (np.s_[:r], np.s_[-r:]):
        assert np.abs(ref[edge] - got[edge]).max() < 0.05
        assert np.abs(ref[:, edge] - got[:, edge]).max() < 0.05


@pytest.mark.parametrize('size', [3, 5, 8])
def test_uniform_filter_matches_jax(size):
    img = synth_page(60, 70).astype(np.float32)
    ref = np.asarray(JF.uniform_filter(img[None], size))[0]
    got = TF.uniform_filter(_t(img[None]), size).numpy()[0]
    assert np.abs(ref - got).max() < 0.05
    assert np.abs(ref[:, :size] - got[:, :size]).max() < 0.05


def test_symmetric_pad_repeats_the_edge():
    """A step at the first column: 'reflect' with the edge repeated keeps
    the first output at the edge value's blur, unlike torch's pad."""
    img = np.zeros((1, 4, 9), np.float32)
    img[..., 0] = 9.0
    got = TF.uniform_filter(_t(img), 3).numpy()[0]
    # columns -1, 0, 1 = 9, 9, 0 (torch's reflect would give 0, 9, 0)
    assert got[0, 0] == pytest.approx(6.0)
    assert got[0, 1] == pytest.approx(3.0)


def _mask_and_pages(rgb):
    g = synth_page(60, 70, seed=3)
    mask = g < 100
    img = np.stack([g, np.clip(g.astype(int) + 20, 0, 255),
                    np.clip(g.astype(int) - 20, 0, 255)], -1) \
        .astype(np.uint8) if rgb else g
    return mask, img


@pytest.mark.parametrize('rgb', [False, True])
@pytest.mark.parametrize('fn,arg', [('partial_blur', 5),
                                    ('partial_blur', 2),
                                    ('partial_boxblur', 5)])
def test_partial_blurs_match_jax(fn, arg, rgb):
    mask, img = _mask_and_pages(rgb)
    ref = np.asarray(getattr(JF, fn)(mask[None], img[None], arg))[0]
    got = getattr(TF, fn)(_t(mask[None]), _t(img[None]), arg).numpy()[0]
    assert got.dtype == np.uint8 and got.shape == img.shape
    assert (got[mask] == img[mask]).all()
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert (diff == 0).mean() >= 0.999
    assert diff.max() <= 1
