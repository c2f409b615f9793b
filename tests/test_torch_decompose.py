"""The PyTorch port's MRC decomposition held against the JAX package's,
on synthetic scans (``tests/scanfix.py``), with and without hOCR lines.

Where line boxes overlap, the JAX package's two CPU forms disagree: its
XLA id map counts a line's ink only where no later line covers it, and
blanks an overlap whose later line is not selected; its Pallas path
follows the reference (``mrc.py:188-270``).  The port follows the Pallas
path, so on overlapping boxes it is held to that path and to the
reference oracle ``tests/test_decompose.py:mask_pipeline_ref``, never to
the XLA id map.  Without overlaps all of them agree.
"""

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu.mrc import api as JA

from archive_pdf_tools_tpu_torch.mrc import api as TA
from archive_pdf_tools_tpu_torch.ops import lines_cuda, paste_cuda
from archive_pdf_tools_tpu_torch.parallel import sharded

import tests.test_decompose as JT
from tests.scanfix import synth_scan
from tests.test_kernels import synth_page

torch.set_num_threads(2)

DPI = 150


def _rgb(p):
    return np.stack([p, np.clip(p.astype(int) + 6, 0, 255),
                     np.clip(p.astype(int) - 6, 0, 255)], -1).astype(np.uint8)


def _batch(noise, rgb, seeds=(1, 2), words=False, h=120):
    scans = [synth_scan(h=h, w=300, seed=s, dpi=DPI, noise_sigma=noise)
             for s in seeds]
    pages = [_rgb(p) if rgb else p for p, _ in scans]
    wds = [wd if words else [] for _, wd in scans]
    return pages, wds


def _port(pages, wds, **kw):
    mask, dev = TA.decompose_masks(pages, wds, dpi=DPI, device='cpu', **kw)
    fg, bg = TA.decompose_layers(mask, dev)
    return mask.numpy(), fg, bg


def _jax(pages, wds, **kw):
    mask, dev = JA.decompose_masks(pages, wds, dpi=DPI, **kw)
    fg, bg = JA.decompose_layers(mask, dev)
    return np.asarray(mask), fg, bg


def _noise_free_bit_exact(rgb, words):
    # sigma_est <= 1: identity blur taps on both sides; the line boxes
    # of synth_scan do not overlap
    pages, wds = _batch(0.0, rgb, words=words, h=240 if words else 120)
    if words:
        assert all(wd[0]['lines'] for wd in wds)
    tm, tf, tb = _port(pages, wds)
    jm, jf, jb = _jax(pages, wds)
    assert tm.any() and not tm.all()
    assert (tm == jm).all()
    assert (tf == jf).all()
    assert (tb == jb).all()


def _noisy_agree(rgb, words):
    pages, wds = _batch(9.0, rgb, words=words, h=240 if words else 120)
    tm, _, _ = _port(pages, wds)
    jm, jf, jb = _jax(pages, wds)
    assert (tm == jm).mean() >= 0.9999
    # the fills given the JAX mask are exact
    tf, tb = TA.decompose_layers(torch.from_numpy(np.array(jm)),
                                 torch.from_numpy(np.stack(pages)))
    assert (tf == jf).all()
    assert (tb == jb).all()


@pytest.mark.parametrize('rgb', [False, True])
def test_noise_free_pages_bit_exact(rgb):
    _noise_free_bit_exact(rgb, words=False)


@pytest.mark.parametrize('rgb', [False, True])
def test_noise_free_pages_with_lines_bit_exact(rgb):
    _noise_free_bit_exact(rgb, words=True)


@pytest.mark.parametrize('rgb', [False, True])
def test_noisy_pages_agree(rgb):
    _noisy_agree(rgb, words=False)


@pytest.mark.parametrize('rgb', [False, True])
def test_noisy_pages_with_lines_agree(rgb):
    _noisy_agree(rgb, words=True)


def test_timing_keys_match_reference():
    pages, wds = _batch(0.0, True, seeds=(3,))
    sink_t, sink_j = [], []
    mask, dev = TA.decompose_masks(pages, wds, dpi=DPI, device='cpu',
                                   timing_data=sink_t)
    TA.decompose_layers(mask, dev, timing_data=sink_t)
    mask, dev = JA.decompose_masks(pages, wds, dpi=DPI, timing_data=sink_j)
    JA.decompose_layers(mask, dev, timing_data=sink_j)
    assert [k for k, _ in sink_t] == [k for k, _ in sink_j]


def test_page_with_hocr_line_raises():
    """Formerly: a page with hOCR lines raised.  Now a batch of a page
    without lines and a page with lines runs, bit-exact with the JAX
    package, and the page without lines keeps the global mask."""
    page, word_data = synth_scan(h=240, w=300, seed=1, dpi=DPI,
                                 noise_sigma=0)
    assert word_data[0]['lines']
    tm, _, _ = _port([page, page], [[], word_data])
    jm, _, _ = _jax([page, page], [[], word_data])
    assert (tm == jm).all()
    alone, _, _ = _port([page], [[]])
    assert (tm[0] == alone[0]).all()


@pytest.mark.parametrize('kw', [{'downsample': 2}, {'denoise_mask': 'bregman'},
                                {'exact_denoise': False}])
def test_unported_mask_options_raise(kw):
    """Formerly: ``denoise_mask='bregman'`` and ``exact_denoise=False``
    raised.  Each mask option now runs and equals the JAX package's mask
    (``downsample`` divides the line boxes, as the pages were; bregman is
    the TV denoise, ``exact_denoise=False`` the one-pass despeckle), and
    each changes the mask."""
    page, word_data = synth_scan(h=240, w=300, seed=1, dpi=DPI,
                                 noise_sigma=0)
    tm, _, _ = _port([page], [word_data], **kw)
    jm, _, _ = _jax([page], [word_data], **kw)
    assert (tm == jm).all()
    full, _, _ = _port([page], [word_data])
    assert (tm != full).any()


def test_no_gpu_no_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        TA.decompose_masks(_batch(0.0, False, seeds=(1,))[0], [[]], dpi=DPI)


def _overlap_page():
    """Each line box grown 12 rows down: 3 of 4 neighbours overlap."""
    page, wd = synth_scan(h=240, w=300, seed=3, dpi=DPI, noise_sigma=0)
    for line in wd[0]['lines']:
        x0, y0, x1, y1 = line['bbox']
        line['bbox'] = [x0, y0, x1, min(240, y1 + 12)]
        for word in line['words']:
            word['bbox'] = list(line['bbox'])
    return page, wd


def test_overlapping_boxes_match_pallas_path_and_oracle(monkeypatch):
    page, wd = _overlap_page()
    boxes = [ln['bbox'] for ln in wd[0]['lines']]
    assert any(a[3] > b[1] for a, b in zip(boxes, boxes[1:]))
    sink_t, sink_j = [], []
    mask, _ = TA.decompose_masks([page], [wd], dpi=DPI, device='cpu',
                                 timing_data=sink_t)
    tm = mask.numpy()[0]
    assert (tm == JT.mask_pipeline_ref(page, wd, DPI)).all()
    monkeypatch.setenv('APT_TPU_KERNELS', 'pallas')
    jm, _ = JA.decompose_masks([page], [wd], dpi=DPI, timing_data=sink_j)
    assert (tm == np.asarray(jm)[0]).all()
    # the port's stage keys are those of the JAX package's Pallas path
    assert [k for k, _ in sink_t] == [k for k, _ in sink_j]


# --- the mask cases of tests/test_decompose.py:97-312, against the oracle ---

def _tall_overlap_page():
    h, w = 900, 480
    rng = np.random.default_rng(5)
    img = np.full((h, w), 225, np.uint8)
    img[40:470, 30:450] = 50                 # dark headline band
    for x in range(50, 430, 46):
        img[80:430, x:x + 20] = 215          # light glyphs
    for y in (500, 540):
        img[y:y + 24, 40:460] = 60           # normal body strokes
    img = np.clip(img.astype(np.float32) + rng.normal(0, 6, img.shape),
                  0, 255).astype(np.uint8)

    def line(bbox, text, size):
        return {'bbox': bbox, 'baseline': (0.0, 0),
                'words': [{'text': text, 'bbox': bbox, 'confidence': 90,
                           'writing_direction': 0, 'fontsize': size}]}
    return img, [{'lines': [line([30, 40, 450, 600], 'HEAD', 300),
                            line([200, 495, 470, 570], 'body', 12)]}]


def _oracle_case(case):
    """(pages, word datas, dpi) of each mirrored case."""
    tall = JT.TestTallLines._tall_page
    if case == 'gray':
        return ([synth_page(200, 300, seed=42, noise=25)],
                [JT.synth_word_data(200, 300)], 80)
    if case == 'batch':
        return ([synth_page(160, 240, seed=s, noise=15) for s in range(3)],
                [JT.synth_word_data(160, 240, seed=s) for s in range(3)], 100)
    if case == 'tall_300':
        img, wd = tall(None)
        return [img], [wd], 600
    if case in ('tall_560', 'tall_in_batch', 'tall_only'):
        img, wd = tall(None, h=900)
        wd[0]['lines'][0]['bbox'] = [30, 40, 450, 600]
        if case == 'tall_only':
            wd[0]['lines'] = wd[0]['lines'][:1]
        if case != 'tall_in_batch':
            return [img], [wd], 600
        others = [np.pad(synth_page(640, 480, seed=s, noise=12),
                         ((0, 260), (0, 0)), constant_values=230)
                  for s in range(2)]
        return ([img] + others,
                [wd] + [JT.synth_word_data(640, 480, seed=s)
                        for s in range(2)], 600)
    if case == 'tall_overlap_later_short':
        img, wd = _tall_overlap_page()
        return [img], [wd], 600
    assert case == 'scan_corpus'        # seed 2 holds the inverted band
    scans = [synth_scan(seed=s, h=480, w=360, dpi=150) for s in range(4)]
    return [p for p, _ in scans], [wd for _, wd in scans], 150


@pytest.mark.parametrize('case', ['gray', 'batch', 'tall_300', 'tall_560',
                                  'tall_in_batch', 'tall_overlap_later_short',
                                  'tall_only', 'scan_corpus'])
def test_mask_matches_reference_oracle(case):
    pages, wds, dpi = _oracle_case(case)
    mask, _ = TA.decompose_masks(pages, wds, dpi=dpi, device='cpu')
    got = mask.numpy()
    for i, (page, wd) in enumerate(zip(pages, wds)):
        ref = JT.mask_pipeline_ref(page, wd, dpi=dpi)
        assert (ref == got[i]).mean() >= 0.999, (case, i)
        if case == 'tall_overlap_later_short':
            ov = (slice(495, 570), slice(200, 450))
            assert (ref[ov] == got[i][ov]).mean() >= 0.999


def test_halftone_not_swallowed():
    img, wd = synth_scan(seed=1, h=480, w=360, dpi=150, bleed=False)
    mask, _ = TA.decompose_masks([img], [wd], dpi=150, device='cpu')
    m = mask.numpy()[0]
    fh, fw = 480 // 5, 360 // 3
    fy, fx = 480 - fh - 50, 360 - fw - 30
    assert m[fy:fy + fh, fx:fx + fw].mean() < 0.65


def test_inverted_band_selects_inverse_crop(monkeypatch):
    # the dark header band's light glyphs: the selection needs the
    # wavelet sigma of both crops, fetched from the ragged buffers
    img, wd = synth_scan(seed=2, h=480, w=360, dpi=150)
    seen = {}
    real = paste_cuda.paste_lines

    def spy(crops_t, crops_i, lines, selector, gmask):
        seen['selector'] = np.asarray(selector)
        return real(crops_t, crops_i, lines, selector, gmask)

    monkeypatch.setattr(sharded, 'paste_lines', spy)
    mask, _ = TA.decompose_masks([img], [wd], dpi=150, device='cpu')
    assert seen['selector'][0] == 2      # line 0 is the inverted band
    assert (seen['selector'][1:] == 1).any()
    ref = JT.mask_pipeline_ref(img, wd, dpi=150)
    assert (ref == mask.numpy()[0]).mean() >= 0.999


# --- tests/test_line_capacity.py: the port has no line capacity ---

def test_batch_equals_pages_alone():
    pages = [synth_page(160, 240, seed=s, noise=15) for s in range(4)]
    wds = [JT.synth_word_data(160, 240, seed=s) for s in range(4)]
    whole, _ = TA.decompose_masks(pages, wds, dpi=100, device='cpu')
    for i in range(4):
        alone, _ = TA.decompose_masks(pages[i:i + 1], wds[i:i + 1], dpi=100,
                                      device='cpu')
        assert (alone.numpy()[0] == whole.numpy()[i]).all()


def test_page_of_2000_tiny_lines_drops_none(monkeypatch):
    h, w = 600, 840
    page = synth_page(h, w, seed=8, noise=10)
    lines = []
    for y in range(0, h, 12):
        for x in range(0, w, 20):
            bbox = [x, y, x + 20, y + 12]
            lines.append({'bbox': bbox, 'baseline': (0.0, 0),
                          'words': [{'text': 'x', 'bbox': bbox,
                                     'confidence': 90,
                                     'writing_direction': 0,
                                     'fontsize': 8}]})
    wd = [{'lines': lines}]
    assert len(lines) == 2100
    seen = {}
    real = lines_cuda.line_thresholds

    def spy(gray, rl, window, *a):
        seen['n'] = rl.n
        return real(gray, rl, window, *a)

    monkeypatch.setattr(sharded, 'line_thresholds', spy)
    mask, _ = TA.decompose_masks([page], [wd], dpi=100, device='cpu')
    assert seen['n'] == 2100
    ref = JT.mask_pipeline_ref(page, wd, dpi=100)
    assert (ref == mask.numpy()[0]).mean() >= 0.999
