"""The port's in-tree JPEG2000 encoder (``-J tpu``) held against the JAX
package's: the plain transform bit for bit against the native C++ one
and the XLA-CPU ``_device_transform``; the device-side pack4/pack8
requantisation against the numpy twins; and the emitted bytes against
the JAX encoder's, which on the CPU runs the native transform.
"""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from archive_pdf_tools_tpu.codecs import jp2tpu as J
from archive_pdf_tools_tpu.validators.jp2_check import validate_jp2
from archive_pdf_tools_tpu.validators.jp2t1_check import decode_block

from archive_pdf_tools_tpu_torch.codecs import jp2host as H
from archive_pdf_tools_tpu_torch.codecs import jp2tpu as P
from archive_pdf_tools_tpu_torch.ops.dwt97 import dwt97 as dwt97_plain
from archive_pdf_tools_tpu_torch.ops.dwt97_cuda import dwt97

torch.set_num_threads(2)


def _noise(shape, rgb, seed, batch=2):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch,) + shape + ((3,) if rgb else ()),
                        dtype=np.uint8)


def _page(seed=21, noise=10, shape=(264, 200)):
    """Text-like rows on light paper with sensor noise
    (tests/test_jp2tpu.py TestPack4)."""
    rng = np.random.default_rng(seed)
    img = np.full(shape, 228.0)
    for y in range(20, shape[0] - 20, 22):
        img[y:y + 7, 12:shape[1] - 12] = 45
    return np.clip(img + rng.normal(0, noise, shape), 0, 255).astype(np.uint8)


def _rgb(g):
    return np.stack([g, (g * 0.9).astype(np.uint8),
                     (g * 0.8).astype(np.uint8)], -1)


def _psnr(a, b):
    err = a.astype(float) - b.astype(float)
    return 10 * np.log10(255.0 ** 2 / max(float((err ** 2).mean()), 1e-12))


# (H, W), RGB, requested levels (capped as the encoder caps them), delta
DWT_CASES = [
    ((64, 48), False, 1, 1 / 64), ((64, 48), False, 2, 0.5),
    ((64, 48), False, 3, 1 / 64), ((64, 48), False, 5, 1 / 64),
    ((64, 48), True, 3, 0.5), ((64, 48), True, 5, 1 / 64),
    ((97, 131), False, 1, 0.5), ((97, 131), False, 4, 1 / 64),
    ((97, 131), False, 5, 0.5), ((97, 131), True, 2, 1 / 64),
    ((97, 131), True, 4, 0.5),
    ((257, 193), False, 4, 1 / 64), ((257, 193), False, 5, 1 / 64),
    ((257, 193), False, 5, 0.5), ((257, 193), True, 3, 0.5),
    ((257, 193), True, 5, 1 / 64),
    ((5, 7), False, 5, 1 / 64), ((5, 7), True, 2, 0.5),
]


@pytest.mark.parametrize('shape,rgb,levels,delta', DWT_CASES)
def test_plain_dwt97_equals_native_and_xla(shape, rgb, levels, delta):
    lv = P.capped_levels(shape[0], shape[1], levels)
    img = _noise(shape, rgb, seed=shape[0] * 7 + levels)
    ours = dwt97_plain(torch.from_numpy(img), lv, delta)
    native = H._native_transform(img, lv, rgb, delta)
    xla = J._device_transform(img, lv, rgb, delta)
    assert len(ours) == len(native) == len(xla) == (3 if rgb else 1)
    shapes = H._band_shapes(shape[1], shape[0], lv)
    for o, n, x in zip(ours, native, xla):
        assert len(o) == 3 * lv + 1
        for k, (a, b, c) in enumerate(zip(o, n, x)):
            assert a.dtype == torch.int32
            assert tuple(a.shape) == (2,) + shapes[k]
            assert np.array_equal(a.numpy(), b), k
            assert np.array_equal(a.numpy(), np.asarray(c)), k


def test_dwt97_wrapper_takes_the_plain_version_on_cpu():
    img = torch.from_numpy(_noise((40, 33), True, seed=5))
    got, ref = dwt97(img, 3, 0.5), dwt97_plain(img, 3, 0.5)
    assert all(torch.equal(a, b) for ga, ra in zip(got, ref)
               for a, b in zip(ga, ra))
    with pytest.raises(TypeError):
        dwt97(img.float(), 3, 0.5)
    with pytest.raises(ValueError):
        dwt97(img[..., :2].contiguous(), 3, 0.5)
    with pytest.raises(ValueError):
        dwt97(img, 0, 0.5)
    with pytest.raises(ValueError):
        dwt97(img.to('meta'), 3, 0.5)


@pytest.mark.parametrize('pack,rgb,delta', [
    ('pack4', False, 1 / 64), ('pack4', True, 1 / 64), ('pack4', False, 0.5),
    ('pack8', False, 1 / 64), ('pack8', True, 1 / 64)])
def test_device_pack_equals_numpy_twins(pack, rgb, delta):
    g = _page(seed=22)
    imgs = np.stack([g, 255 - g, np.full_like(g, 128)])
    if rgb:
        imgs = np.stack([_rgb(p) for p in imgs])
    levels = 5
    qb = dwt97_plain(torch.from_numpy(imgs), levels, delta)
    qb_np = [[q.numpy() for q in comp] for comp in qb]
    layout = H.band_layout(levels, delta)
    nb = 3 * levels + 1
    if pack == 'pack4':
        k3, k7 = H._pack4_sets(nb, levels)
        kmap = {k: 3 for k in k3}
        kmap.update({k: 7 for k in k7})
        twin = H._packK_shifts_np(qb_np, layout, kmap)
        twin_bands = H._packK_apply_np(qb_np, twin, kmap)
        twin8 = H._packK_shifts_np(qb_np, layout, {k: 7 for k in k3})
        assert np.array_equal(
            P.pack_shifts(qb, {k: 7 for k in k3}, layout).numpy(), twin8)
    else:
        kmap = {k: 7 for k in range(nb - 6, nb)}
        twin = H._pack8_shifts_np(qb_np, 6, layout)
        twin_bands = H._pack8_apply_np(qb_np, twin, 6)
    shifts = P.pack_shifts(qb, kmap, layout)
    assert np.array_equal(shifts.numpy(), twin)
    assert shifts.numpy().max() > 0
    for comp, tcomp in zip(P.pack_apply(qb, shifts, kmap), twin_bands):
        for q, t in zip(comp, tcomp):
            assert q.numpy().dtype == t.dtype
            assert np.array_equal(q.numpy(), t)
    # the batch API's meta and pages equal the JAX package's (on the
    # CPU: the native transform and the numpy twins)
    ratio = 500 if pack == 'pack4' else 250
    pages, meta = P.transform_jp2_batch(imgs, base_delta=delta, ratio=ratio,
                                        pack8=True, device='cpu')
    jpages, jmeta = J.transform_jp2_batch(imgs, base_delta=delta,
                                          ratio=ratio, pack8=True)
    assert meta['shifts'] == jmeta['shifts'] == twin.tolist()
    assert meta.get('kplanes') == jmeta.get('kplanes')
    for p, jp in zip(pages, jpages):
        for c, jc in zip(p, jp):
            for q, jq in zip(c, jc):
                assert q.dtype == jq.dtype and np.array_equal(q, jq)


@pytest.mark.parametrize('ratio', [30, 500, 750, None])
@pytest.mark.parametrize('rgb', [False, True])
def test_encode_bytes_equal_jax(ratio, rgb):
    g = _page(seed=23)
    imgs = np.stack([g, g[::-1].copy()])
    if rgb:
        imgs = np.stack([_rgb(p) for p in imgs])
    assert (P.encode_jp2_tpu(imgs[0], ratio=ratio, device='cpu')
            == J.encode_jp2_tpu(imgs[0], ratio=ratio))
    # batched: pack4 from ratio 400, on one set of shifts for the batch
    assert (P.encode_jp2_tpu_batch(imgs, ratio=ratio, device='cpu')
            == J.encode_jp2_tpu_batch(imgs, ratio=ratio))


def test_pack8_batch_bytes_equal_jax():
    imgs = np.stack([_rgb(_page(seed=24)), _rgb(_page(seed=25))])
    got = P.encode_jp2_tpu_batch(imgs, ratio=250, pack8=True, device='cpu')
    assert got == J.encode_jp2_tpu_batch(imgs, ratio=250, pack8=True)


def test_pack4_starvation_refetch_equals_jax(monkeypatch):
    """One plane for the finest bands, encoded at a generous rate: the
    allocator starves them and the int8 band is fetched from the device
    (``_host_encode``'s refetch round), as the JAX package does with
    APT_JP2_PACK4=1 and APT_JP2_PACK4_K=1."""
    monkeypatch.setenv('APT_T1_STATS', '1')
    img = _page(seed=24, noise=16)
    H.T1_STATS.pop('pack4_refetch', None)
    pages, meta = P.transform_jp2_batch(img[None], ratio=500, k_fine=1,
                                        device='cpu')
    assert meta['kplanes'] and set(meta['kplanes'].values()) == {1}
    ours = P.encode_jp2_from_qbands(pages[0], meta, ratio=20, page_idx=0)
    assert H.T1_STATS.get('pack4_refetch', (0, 0))[1] >= 1
    monkeypatch.setenv('APT_JP2_PACK4', '1')
    monkeypatch.setenv('APT_JP2_PACK4_K', '1')
    assert ours == J.encode_jp2_tpu_batch(img[None], ratio=20)[0]
    assert validate_jp2(ours)['packet_walk']


@pytest.mark.parametrize('ratio', [40, None])
def test_batch_bytes_equal_per_page_bytes(ratio):
    imgs = _noise((120, 160), False, seed=4, batch=3)
    batch = P.encode_jp2_tpu_batch(imgs, ratio=ratio, device='cpu')
    assert batch == [P.encode_jp2_tpu(im, ratio=ratio, device='cpu')
                     for im in imgs]
    # the async API's meta waits for the drain before it is read
    fetch, meta = P.transform_jp2_batch_async(torch.from_numpy(imgs))
    assert meta['shifts'] is None and meta['levels'] == 4
    assert [P.encode_jp2_from_qbands(fetch(i), meta, ratio=ratio)
            for i in range(3)] == batch


@pytest.mark.parametrize('ratio,rgb,min_psnr', [
    (30, False, 35.0), (30, True, 38.0), (500, False, 15.0),
    (750, True, 19.0)])
def test_streams_validate_and_decode(ratio, rgb, min_psnr):
    """Each stream passes the strict validator, decodes with Pillow
    (OpenJPEG) above a PSNR floor, and a sampled code block decodes with
    the from-spec Tier-1 decoder to the quantised coefficients."""
    img = _page(seed=26, noise=2)
    if rgb:
        img = _rgb(img)
    pages, meta = P.transform_jp2_batch(img[None], ratio=ratio,
                                        device='cpu')
    data = P.encode_jp2_from_qbands(pages[0], meta, ratio=ratio, page_idx=0)
    blks = []
    facts = validate_jp2(data, collect_blocks=blks)
    assert facts['packet_walk'] and blks
    assert (facts['w'], facts['h'], facts['ncomp']) == (200, 264,
                                                        3 if rgb else 1)
    dec = np.asarray(Image.open(io.BytesIO(data)).convert(
        'RGB' if rgb else 'L'))
    assert dec.shape == img.shape
    assert _psnr(dec, img) > min_psnr, _psnr(dec, img)
    # the LL block of component 0: every plane coded (no truncation at
    # these rates), so it decodes to the (unshifted) coefficients
    rec = next(b for b in blks if b['res'] == 0)
    mag, sgn = decode_block(rec['data'], rec['w'], rec['h'], rec['orient'],
                            rec['nbps'], rec['npasses'])
    got = (np.asarray(mag) * (1 - 2 * np.asarray(sgn))).reshape(
        rec['h'], rec['w'])
    ll = pages[0][0][0][:rec['h'], :rec['w']]
    if rec['npasses'] == 3 * rec['nbps'] - 2:
        assert np.array_equal(got, ll)
    else:
        assert np.all(np.abs(got) <= np.abs(ll))
