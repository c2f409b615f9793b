"""The PyTorch port's kernel-bearing ops held against the JAX package.

Each plain PyTorch version (the CPU path of a CUDA kernel wrapper) gets
the same numpy inputs as the JAX function on CPU (its scan / XLA form),
the reference oracle in ``ops/golden.py`` and, on one tiny case each,
the Pallas kernel itself in interpret mode.  The kernels themselves run
only on a GPU and are compared with these plain versions by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from archive_pdf_tools_tpu.ops import golden
from archive_pdf_tools_tpu.ops.optimise import optimise as jax_optimise
from archive_pdf_tools_tpu.ops.denoise import (
    fast_mask_denoise_exact as jax_denoise)
from archive_pdf_tools_tpu.ops.sigma import estimate_noise as jax_noise
from archive_pdf_tools_tpu.mrc import decompose as JD
from archive_pdf_tools_tpu.utils.backend import (
    pack_mask_bits as jax_pack_mask_bits)

from archive_pdf_tools_tpu_torch.ops.optimise_cuda import optimise
from archive_pdf_tools_tpu_torch.ops.denoise_cuda import fast_mask_denoise
from archive_pdf_tools_tpu_torch.ops.threshold_cuda import (
    blur_sauvola, separable_blur)
from archive_pdf_tools_tpu_torch.ops.lines_cuda import (RaggedLines,
                                                        line_thresholds)
from archive_pdf_tools_tpu_torch.ops.paste_cuda import paste_lines
from archive_pdf_tools_tpu_torch.ops.sigma import estimate_noise
from archive_pdf_tools_tpu_torch.ops.sauvola import sauvola_mask
from archive_pdf_tools_tpu_torch.mrc import decompose as TD
from archive_pdf_tools_tpu_torch.utils.backend import (pack_mask_bits,
                                                       unpack_mask_bits)

from tests.test_kernels import synth_page

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rgb(g):
    return np.stack([g, np.clip(g.astype(int) + 9, 0, 255),
                     np.clip(g.astype(int) - 9, 0, 255)], -1).astype(np.uint8)


# --- K1: optimise (radiate fill) -------------------------------------------

def _optimise_case(case):
    if case == 'batched_nonaligned':
        imgs = np.stack([synth_page(50, 130, seed=s) for s in range(3)])
        masks = np.stack([golden.sauvola_mask_ref(i, 15, 15, 0.34)
                          for i in imgs])
        return masks, imgs, 3
    if case in ('empty', 'full'):
        img = synth_page(40, 128)[None]
        fill = np.ones if case == 'full' else np.zeros
        return fill((1, 40, 128), bool), img, 3
    kind, n = case.split('_')
    g = synth_page(70 if kind == 'gray' else 60, 150 if kind == 'gray'
                   else 140, seed=int(n))
    mask = golden.sauvola_mask_ref(g, 15, 15, 0.34)[None]
    img = (g if kind == 'gray' else _rgb(g))[None]
    return mask, img, int(n)


@pytest.mark.parametrize('case', ['gray_3', 'gray_10', 'rgb_3', 'rgb_10',
                                  'batched_nonaligned', 'empty', 'full'])
def test_optimise_matches_golden_and_jax(case):
    mask, img, n = _optimise_case(case)
    got = optimise(_t(mask), _t(img), n).numpy()
    ref = np.stack([golden.optimise_ref(m, i, n) for m, i in zip(mask, img)])
    assert (got == ref).all()
    assert (got == np.asarray(jax_optimise(mask, img, n))).all()


def test_optimise_matches_pallas_interpret():
    from archive_pdf_tools_tpu.ops.optimise_pallas import optimise_pallas
    g = synth_page(40, 130, seed=4)
    mask = golden.sauvola_mask_ref(g, 15, 15, 0.34)[None]
    ref = np.asarray(optimise_pallas(mask, g[None], 10, interpret=True))
    assert (optimise(_t(mask), _t(g[None]), 10).numpy() == ref).all()


# --- K2: exact despeckle ------------------------------------------------------

def _denoise_case(case):
    if case == 'random':
        return np.random.default_rng(11).random((2, 70, 140)) < 0.25
    if case == 'random_wide':
        return np.random.default_rng(7).random((2, 50, 300)) < 0.3
    if case == 'text':
        img = synth_page(90, 150, seed=3)
        return golden.sauvola_mask_ref(img, 15, 15, 0.34)[None]
    m = np.zeros((1, 20, 400), bool)
    if case == 'and_chain':           # every pixel counts exactly mincnt
        m[0, 10, :] = True
    elif case == 'band':
        m[0, 8:12, ::2] = True
        m[0, 9, :] = True
    else:                             # isolated speckles, dropped
        m[0, 5, 5] = m[0, 7, 100] = m[0, 15, 399] = True
    return m


@pytest.mark.parametrize('case', ['random', 'random_wide', 'text',
                                  'and_chain', 'band', 'speckles'])
def test_despeckle_matches_golden_and_jax(case):
    mask = _denoise_case(case)
    got = fast_mask_denoise(_t(mask), 4, 2).numpy()
    ref = np.stack([golden.fast_mask_denoise_ref(m, 4, 2) for m in mask])
    assert (got == ref).all()
    assert (got == np.asarray(jax_denoise(mask, 4, 2))).all()


def test_despeckle_matches_pallas_interpret():
    from archive_pdf_tools_tpu.ops.denoise_pallas import \
        fast_mask_denoise_pallas
    mask = np.random.default_rng(3).random((1, 30, 140)) < 0.3
    ref = np.asarray(fast_mask_denoise_pallas(mask, 4, 2, interpret=True))
    assert (fast_mask_denoise(_t(mask), 4, 2).numpy() == ref).all()


# --- K1 and K2 at the edges chip_smoke.py phase 2b holds the kernels to ----
# widths off the warp and word grain and below 2n+1 columns, fewer than 5
# rows, masks all set and all clear, uniform noise at 30/50/70% ink

K1_EDGES = [(2, 3, 31, 1, 3, 0.3), (1, 4, 19, 3, 10, 0.3),
            (2, 5, 6, 1, 3, 0.3), (1, 2, 70, 3, 1, 0.3),
            (1, 17, 45, 3, 1, 0.3), (2, 12, 65, 3, 10, 0.3),
            (1, 20, 33, 1, 3, 1.0), (1, 20, 33, 3, 10, 0.0),
            (1, 20, 33, 3, 3, 1.0)]


@pytest.mark.parametrize('b,h,w,c,n,ink', K1_EDGES)
def test_optimise_edges_match_jax(b, h, w, c, n, ink):
    rng = np.random.default_rng(h * w + n)
    mask = rng.random((b, h, w)) < ink
    img = rng.integers(0, 256, (b, h, w) + ((c,) if c > 1 else ()),
                       dtype=np.uint8)
    got = optimise(_t(mask), _t(img), n).numpy()
    assert (got == np.asarray(jax_optimise(mask, img, n))).all()


@pytest.mark.parametrize('n', [1, 3, 10, 22])
def test_optimise_kernel_layout_takes_wide_pages(n):
    """The CUDA wrapper's split of a row: one CTA up to the widest strip
    its shared memory holds, a cluster of CTAs past it up to
    ``max_width(n)``, and past that strips of one CTA each (the
    wavefront), so every width is taken and its strips cover each column
    once."""
    from archive_pdf_tools_tpu_torch.ops import optimise_cuda as oc
    wmax = oc.max_width(n)
    one = oc.one_cta(n)
    assert wmax == oc.MAX_CLUSTER * one and wmax >= 19370
    assert oc.strips(one, n) == 1 and oc.strips(one + 1, n) == 2
    assert oc.strips(wmax, n) == oc.MAX_CLUSTER
    assert oc.strips(wmax + 1, n) == oc.MAX_CLUSTER + 1
    for w in (1, 2550, 5100, 7000, 19370, wmax, wmax + 1, 47105, 65537,
              120000, 10 ** 6):
        k = oc.strips(w, n)
        q = oc.pitch(-(-w // k))
        # strips [i q, i q + q) cover [0, w), the last one not empty
        assert k * q >= w > (k - 1) * q
        assert q <= one <= oc.COLS * oc.MAX_THREADS
        assert oc.walk_smem(q, n) <= oc.SMEM


K2_EDGES = [(2, 4, 40, 0.5), (1, 3, 37, 0.5), (2, 50, 4, 0.5),
            (1, 40, 70, 0.3), (1, 40, 70, 0.5), (1, 40, 70, 0.7),
            (1, 40, 33, 1.0), (1, 40, 33, 0.0)]


@pytest.mark.parametrize('b,h,w,ink', K2_EDGES)
def test_despeckle_edges_match_jax(b, h, w, ink):
    mask = np.random.default_rng(h * w).random((b, h, w)) < ink
    got = fast_mask_denoise(_t(mask), 4, 2).numpy()
    assert (got == np.asarray(jax_denoise(mask, 4, 2))).all()


# --- K3: blur + global Sauvola ----------------------------------------------

def _identity(b, r):
    taps = np.zeros((b, 2 * r + 1), np.float32)
    taps[:, r] = 1.0
    return taps


@pytest.mark.parametrize('shape,window', [((1, 56, 140), 31),
                                          ((2, 120, 300), 25),
                                          ((1, 40, 130), 51)])
def test_blur_sauvola_identity_taps_exact(shape, window):
    imgs = np.stack([synth_page(*shape[1:], seed=s, noise=0)
                     for s in range(shape[0])])
    got = blur_sauvola(_t(imgs), _t(_identity(shape[0], 8)), window).numpy()
    ref = np.stack([golden.sauvola_mask_ref(i, window, window, 0.34)
                    for i in imgs])
    assert (got == ref).all()
    jax_ref = np.asarray(JD.global_threshold(
        JD.global_threshold_input(imgs)[0], window))
    assert (got == jax_ref).all()


@pytest.mark.parametrize('h,w,noise', [(60, 150, 22), (120, 300, 30),
                                       (40, 130, 60)])
def test_blur_sauvola_jax_taps_matches_xla_form(h, w, noise):
    # the JAX taps (max radius 48) cross over with from_jax_state; a
    # 40-row page is shorter than the 48-row symmetric pad, so the
    # repeated reflection is exercised too
    imgs = np.stack([synth_page(h, w, seed=s, noise=noise)
                     for s in range(2)])
    taps, sigma = JD.blur_weights(imgs)
    assert float(np.min(sigma)) > 1.0          # real (non-identity) taps
    ttaps, window = TD.from_jax_state(np.array(taps), 31, 'cpu')
    got, _ = TD.global_mask(_t(imgs), window, taps=ttaps)
    blurred, _ = JD.global_threshold_input(imgs)
    ref = np.asarray(JD.global_threshold(blurred, 31))
    assert (got.numpy() == ref).mean() >= 0.9999
    blur_got = separable_blur(_t(imgs), ttaps).numpy()
    assert np.abs(blur_got.astype(int)
                  - np.asarray(blurred).astype(int)).max() <= 1


def test_blur_sauvola_matches_scipy_and_pallas_interpret():
    import scipy.ndimage as ndi
    from archive_pdf_tools_tpu.ops import threshold_pallas as tp
    img = synth_page(60, 150, seed=2, noise=0)[None]
    sigma = 1.2
    idx = np.arange(-8, 9, dtype=np.float64)
    wts = np.exp(-0.5 * idx ** 2 / sigma ** 2)
    wts = (wts / wts.sum()).astype(np.float32)[None]
    got = blur_sauvola(_t(img), _t(wts), 31).numpy()[0]
    blurred = ndi.gaussian_filter(img[0].astype(np.float32), sigma=sigma,
                                  truncate=8 / sigma)
    ref = golden.sauvola_mask_ref(blurred.astype(np.uint8), 31, 31, 0.34)
    assert (ref == got).mean() > 0.998   # f32 blur vs f64 scipy
    pallas = np.asarray(tp.blur_sauvola_pallas(img, wts, 31, interpret=True,
                                               radius=8))[0]
    assert (pallas == got).mean() >= 0.9999  # folded vs unfolded tap order


def bright_page(h, w, seed=0):
    """Bright paper (240-255) with mid-grey (150) strokes: a window of it
    has a sum of squares near 65025 * window^2."""
    rng = np.random.default_rng(seed)
    img = rng.integers(240, 256, (h, w)).astype(np.uint8)
    for y in range(8, h - 8, 23):
        for x in range(10, w - 14, 9):
            img[y:y + 5, x:x + 4] = 150
    return img


@pytest.mark.parametrize('window', [183, 201])
def test_sauvola_mask_large_window_matches_jax(window):
    # past 2^31 for window >= 183: the port keeps the sum of squares
    # exact (int64 here, uint32 in the kernel), like the JAX package
    from archive_pdf_tools_tpu.ops.sauvola import sauvola_mask as jax_sauvola
    img = bright_page(260, 300)[None]
    got = sauvola_mask(_t(img), window, window, 0.34).numpy()
    assert (got == np.asarray(jax_sauvola(img, window, window, 0.34))).all()
    assert got.any()                  # the strokes are ink
    ident = _identity(1, 4)
    assert (blur_sauvola(_t(img), _t(ident), window).numpy() == got).all()


def test_blur_sauvola_refuses_window_over_uint32_limit():
    img = _t(bright_page(40, 60)[None])
    blur_sauvola(img, _t(_identity(1, 4)), 255)
    with pytest.raises(ValueError, match='limit'):
        blur_sauvola(img, _t(_identity(1, 4)), 257)


@pytest.mark.parametrize('k', [0.34, 0.1, -0.2])
def test_sauvola_mask_matches_jax(k):
    from archive_pdf_tools_tpu.ops.sauvola import sauvola_mask as jax_sauvola
    img = synth_page(100, 150, seed=5)[None]
    got = sauvola_mask(_t(img), 15, 15, k).numpy()
    assert (got == np.asarray(jax_sauvola(img, 15, 15, k))).all()


# --- noise estimate and blur taps ---------------------------------------------

@pytest.mark.parametrize('h,w,noise', [(120, 300, 20), (70, 150, 5),
                                       (33, 47, 40)])
def test_estimate_noise_matches_jax_and_golden(h, w, noise):
    imgs = np.stack([synth_page(h, w, seed=s, noise=noise)
                     for s in range(2)])
    got = estimate_noise(_t(imgs)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_noise(imgs)), rtol=1e-5)
    hs, he = int(h / 2 - h / 4), int(h / 2 + h / 4)
    ws, we = int(w / 2 - w / 4), int(w / 2 + w / 4)
    gold = [golden.estimate_sigma_np(i[hs:he, ws:we]) for i in imgs]
    np.testing.assert_allclose(got, gold, rtol=1e-4)


@pytest.mark.parametrize('noise', [0, 8, 30])
def test_blur_weights_match_jax(noise):
    imgs = np.stack([synth_page(80, 200, seed=s, noise=noise)
                     for s in range(2)])
    sig = estimate_noise(_t(imgs))
    got = TD.blur_weights_from_sigma(sig)
    ref, jsig = JD.blur_weights(imgs)
    # noise-free pages estimate ~1e-5: only the identity decision matters
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    bucket = TD.pick_blur_radius(sig)
    assert bucket == JD.pick_blur_radius(imgs)
    small = TD.blur_weights_from_sigma(sig, bucket).numpy()
    r = TD.MAX_BLUR_RADIUS
    np.testing.assert_allclose(small, np.asarray(ref)[:, r - bucket:
                                                      r + bucket + 1],
                               atol=1e-6)


# --- bit packing, gray conversion, dispatch -------------------------------------

@pytest.mark.parametrize('w', [8, 13, 130])
def test_pack_mask_bits_matches_numpy_and_jax(w):
    mask = np.random.default_rng(w).random((2, 5, w)) < 0.5
    got = pack_mask_bits(_t(mask)).numpy()
    assert (got == np.packbits(mask, axis=-1)).all()
    assert (got == np.asarray(jax_pack_mask_bits(jnp.asarray(mask)))).all()
    assert (unpack_mask_bits(_t(got), w) == mask).all()


def test_gray_601_matches_jax():
    rgb = np.random.default_rng(0).integers(0, 256, (2, 9, 17, 3),
                                            dtype=np.uint8)
    assert (TD.gray_601(_t(rgb)).numpy()
            == np.asarray(JD.gray_601(rgb))).all()


@pytest.mark.parametrize('call', ['optimise', 'despeckle', 'blur_sauvola',
                                  'line_thresholds', 'paste_lines'])
def test_wrappers_reject_bad_inputs(call):
    img = torch.zeros((1, 8, 8), dtype=torch.uint8)
    lines = RaggedLines([[1, 3, 2, 6]], [0], 1, 8, 8, 'cpu')
    with pytest.raises((TypeError, ValueError)):
        if call == 'optimise':
            optimise(img, img, 3)                       # uint8 mask
        elif call == 'despeckle':
            fast_mask_denoise(img, 4, 2)                # uint8 mask
        elif call == 'blur_sauvola':
            blur_sauvola(img, torch.ones((1, 4)), 15)   # even tap count
        elif call == 'line_thresholds':
            line_thresholds(img[:, :4], lines, 15)      # not the laid-out page
        else:
            crop = torch.zeros(8, dtype=torch.uint8)
            paste_lines(crop, crop, lines, [3], img.bool())  # selector 3
