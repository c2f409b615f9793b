"""The PyTorch port's MRC decomposition held against the JAX package's,
on synthetic scans (``tests/scanfix.py``) whose hOCR holds no lines."""

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu.mrc import api as JA

from archive_pdf_tools_tpu_torch.mrc import api as TA

from tests.scanfix import synth_scan

torch.set_num_threads(2)

DPI = 150


def _batch(noise, rgb, seeds=(1, 2)):
    pages = [synth_scan(h=120, w=300, seed=s, dpi=DPI,
                        noise_sigma=noise)[0] for s in seeds]
    if rgb:
        pages = [np.stack([p, np.clip(p.astype(int) + 6, 0, 255),
                           np.clip(p.astype(int) - 6, 0, 255)], -1)
                 .astype(np.uint8) for p in pages]
    return pages


def _port(pages):
    mask, dev = TA.decompose_masks(pages, [[] for _ in pages], dpi=DPI,
                                   device='cpu')
    fg, bg = TA.decompose_layers(mask, dev)
    return mask.numpy(), fg, bg


def _jax(pages):
    mask, dev = JA.decompose_masks(pages, [[] for _ in pages], dpi=DPI)
    fg, bg = JA.decompose_layers(mask, dev)
    return np.asarray(mask), fg, bg


@pytest.mark.parametrize('rgb', [False, True])
def test_noise_free_pages_bit_exact(rgb):
    # sigma_est <= 1: identity blur taps on both sides
    pages = _batch(0.0, rgb)
    tm, tf, tb = _port(pages)
    jm, jf, jb = _jax(pages)
    assert tm.any() and not tm.all()
    assert (tm == jm).all()
    assert (tf == jf).all()
    assert (tb == jb).all()


@pytest.mark.parametrize('rgb', [False, True])
def test_noisy_pages_agree(rgb):
    pages = _batch(9.0, rgb)
    tm, _, _ = _port(pages)
    jm, jf, jb = _jax(pages)
    assert (tm == jm).mean() >= 0.9999
    # the fills given the JAX mask are exact
    tf, tb = TA.decompose_layers(torch.from_numpy(np.array(jm)),
                                 torch.from_numpy(np.stack(pages)))
    assert (tf == jf).all()
    assert (tb == jb).all()


def test_timing_keys_match_reference():
    pages = _batch(0.0, True, seeds=(3,))
    sink_t, sink_j = [], []
    mask, dev = TA.decompose_masks(pages, [[]], dpi=DPI, device='cpu',
                                   timing_data=sink_t)
    TA.decompose_layers(mask, dev, timing_data=sink_t)
    mask, dev = JA.decompose_masks(pages, [[]], dpi=DPI,
                                   timing_data=sink_j)
    JA.decompose_layers(mask, dev, timing_data=sink_j)
    assert [k for k, _ in sink_t] == [k for k, _ in sink_j]


def test_page_with_hocr_line_raises():
    page, word_data = synth_scan(h=120, w=300, seed=1, dpi=DPI)
    assert word_data[0]['lines']
    with pytest.raises(NotImplementedError, match='hOCR line'):
        TA.decompose_masks([page, page], [[], word_data], dpi=DPI,
                           device='cpu')


@pytest.mark.parametrize('kw', [{'downsample': 2}, {'denoise_mask': 'bregman'},
                                {'exact_denoise': False}])
def test_unported_mask_options_raise(kw):
    pages = _batch(0.0, False, seeds=(1,))
    with pytest.raises(NotImplementedError):
        TA.decompose_masks(pages, [[]], dpi=DPI, device='cpu', **kw)


def test_no_gpu_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TA.decompose_masks(_batch(0.0, False, seeds=(1,)), [[]], dpi=DPI)
