"""The port's layer resize (``ops/resize.py``) held against the JAX
package's: the PIL-convention matrices and thumbnail sizes are exact;
the float32 products sum in another order (CPU BLAS here, cuBLAS on the
card, XLA in the JAX package), so values are held to +-1 LSB, the JAX
package's own bar against PIL (``ops/resize.py:12-14``)."""

import numpy as np
import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.ops import resize as JR

from archive_pdf_tools_tpu_torch.ops import resize as TR

from tests.test_kernels import synth_page

torch.set_num_threads(2)


@pytest.mark.parametrize('n_in,n_out,filt', [(100, 37, 'bicubic'),
                                             (3300, 1100, 'bicubic'),
                                             (57, 80, 'lanczos'),
                                             (40, 13, 'bilinear')])
def test_resize_matrix_equals_jax(n_in, n_out, filt):
    got = TR.resize_matrix(n_in, n_out, filt)
    assert got.dtype == np.float32
    assert np.array_equal(got, JR.resize_matrix(n_in, n_out, filt))


@pytest.mark.parametrize('w,h,f', [(2550, 3300, 3), (300, 120, 2),
                                   (7, 500, 3), (640, 480, 2.5)])
def test_thumbnail_size_equals_jax_and_pil(w, h, f):
    got = TR.thumbnail_size(w, h, int(w / f), int(h / f))
    assert got == JR.thumbnail_size(w, h, int(w / f), int(h / f))
    im = Image.new('L', (w, h))
    im.thumbnail((int(w / f), int(h / f)))
    assert got == im.size


def _pages(rgb):
    g = np.stack([synth_page(90, 130, seed=s) for s in range(2)])
    if rgb:
        g = np.stack([g, np.clip(g.astype(int) + 9, 0, 255),
                      np.clip(g.astype(int) - 9, 0, 255)], -1)
    return g.astype(np.uint8)


@pytest.mark.parametrize('rgb', [False, True])
def test_resize_within_one_lsb_of_jax(rgb):
    imgs = _pages(rgb)
    got = TR.resize(torch.from_numpy(imgs), 30, 43).numpy()
    ref = np.asarray(JR.resize(imgs, 30, 43))
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    # the exact share: almost every value matches
    assert (diff == 0).mean() >= 0.99


@pytest.mark.parametrize('rgb', [False, True])
def test_downsample_layer_matches_jax(rgb):
    imgs = _pages(rgb)
    for factor in (3, 2.5):
        got, ok = TR.downsample_layer(torch.from_numpy(imgs), factor)
        ref, ok_ref = JR.downsample_layer(imgs, factor)
        assert ok == ok_ref
        assert tuple(got.shape) == np.asarray(ref).shape
        assert np.abs(got.numpy().astype(int)
                      - np.asarray(ref).astype(int)).max() <= 1
    same, ok = TR.downsample_layer(torch.from_numpy(imgs), 200)
    assert not ok and same.shape == imgs.shape
