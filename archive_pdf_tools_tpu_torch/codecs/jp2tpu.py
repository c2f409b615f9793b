"""Device side of the in-tree JPEG2000 encoder (``-J tpu``) and its batch
API, on torch tensors.

Counterpart of the JAX package's ``codecs/jp2tpu.py``: ``encode_jp2_tpu``
(``:1110-1137``), ``transform_jp2_batch_async`` (``:1679-1910``),
``transform_jp2_batch`` and ``encode_jp2_tpu_batch`` (``:1913-1954``).
The transform is ``ops/dwt97_cuda.dwt97`` (the kernel ``csrc/dwt97.cu``
on a CUDA tensor, the plain PyTorch version on a CPU tensor); Tier-1,
rate allocation and Tier-2 are the host encoder in ``codecs/jp2host.py``.

Plane budgets.  At ``ratio >= 400`` (pack4) the finest two resolutions
are requantised to ``k_fine`` magnitude planes and the third-finest to 7;
with ``pack8`` (the pipeline asks for it at ``ratio >= 200``) the finest
two go to 7.  The requantisation q' = sign(q) * min(|q| >> s, 2^K - 1) is
an exact, coarser standard quantiser step (the band's QCD exponent drops
by s), s being the smallest shift that fits the band's max |q| over every
page and component, clamped to the band's exponent.  Shifts and bands
are computed on the device and equal the JAX package's numpy twins
(``_packK_*_np``, ``_pack8_*_np``).  The pack4 int8 forms of the
``k_fine`` bands stay on the device for ``_host_encode``'s starvation
refetch.  Budgeted bands come back as int8, the others as int32: the
JAX package's transfer forms for a thin TPU link (int24 and int16 byte
planes, nibbles, sparse bitmaps) are not ported.

Readback.  On a CUDA device the shipped bands are copied on a side
stream, which waits for the end of the transform, into pinned host
memory, so the copy never queues behind work the main thread launches
later (the next transform, the next batch's kernels).  A background
thread waits for the copy; ``fetch(i)`` blocks until it is done.
"""

import math
import os
import threading

import numpy as np
import torch

from ..ops.dwt97_cuda import dwt97
from ..utils.backend import resolve_device
from .jp2host import (_AsyncMeta, _PACK4_K_FINE, _get_lib, _host_encode,
                      _pack4_sets, band_layout, encode_jp2_from_qbands)


def capped_levels(h, w, levels):
    """Decomposition levels for an h x w image (``jp2tpu.py:1128-1129``)."""
    return max(1, min(levels,
                      max(1, int(math.floor(math.log2(min(h, w) / 4))))))


def _as_tensor(imgs, device):
    """A uint8 tensor stays on its device; numpy pages (one array or a
    list) go to ``device``."""
    if isinstance(imgs, torch.Tensor):
        return imgs.contiguous()
    arr = np.stack(imgs) if isinstance(imgs, (list, tuple)) else imgs
    arr = np.ascontiguousarray(arr, np.uint8)
    return torch.from_numpy(arr).to(resolve_device(device))


def pack_shifts(qbands, kmap, layout):
    """int32 (nb,) on the bands' device: for each band k of ``kmap`` the
    smallest s with max|q| >> s <= 2^K - 1 over every component, clamped
    to the band's exponent eps; 0 for the other bands
    (``_packK_shifts_np``)."""
    dev = qbands[0][0].device
    shifts = torch.zeros(len(qbands[0]), dtype=torch.int32, device=dev)
    steps = torch.arange(31, dtype=torch.int32, device=dev)
    for k, planes in kmap.items():
        mx = torch.stack([q[k].abs().amax() if q[k].numel()
                          else torch.zeros((), dtype=torch.int32, device=dev)
                          for q in qbands]).amax()
        s = ((mx >> steps) > (1 << planes) - 1).sum()
        shifts[k] = torch.clamp(s, max=int(layout[k][3]))
    return shifts


def _requant(q, s, planes):
    return (torch.sign(q) * torch.clamp(q.abs() >> s, max=(1 << planes) - 1)
            ).to(torch.int8)


def pack_apply(qbands, shifts, kmap):
    """Each component's bands with those of ``kmap`` requantised to int8
    (``_packK_apply_np``)."""
    return [tuple(_requant(q, shifts[k], kmap[k]) if k in kmap else q
                  for k, q in enumerate(qb)) for qb in qbands]


def _copy_to_host(tensors):
    """Host copies of ``tensors`` and the CUDA event that marks them
    complete (None on the CPU, where the tensors are their own copies)."""
    dev = tensors[0].device
    if dev.type != 'cuda':
        return tensors, None
    side = torch.cuda.Stream(dev)             # from torch's stream pool
    side.wait_stream(torch.cuda.current_stream(dev))
    host = []
    with torch.cuda.stream(side):
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t.record_stream(side)     # no reuse of t before the copy ran
            host.append(h)
        done = torch.cuda.Event()
        done.record(side)
    return host, done


def transform_jp2_batch_async(imgs, base_delta=1.0 / 64, levels=5,
                              pack8=False, ratio=None, k_fine=_PACK4_K_FINE,
                              device=None):
    """Stage 1 of a batched encode: DC shift / ICT, DWT and quantiser of a
    whole uint8 (B, H, W) or (B, H, W, 3) stack in one kernel launch.
    ``imgs`` is a tensor (used on its device: the fg/bg layers of
    ``decompose_layers(device=True)`` never leave the card as pixels) or
    numpy pages, sent to ``device``.

    ratio: the rate target the pages will be encoded at; pack4 from 400.
    pack8: the int8 fine bands below that.  k_fine: pack4's planes for
    the finest two resolutions (1-3, the JAX package's
    ``APT_JP2_PACK4_K``).

    Returns (fetch, meta): ``fetch(i)`` blocks until page i's numpy
    qbands are ready for ``encode_jp2_from_qbands``."""
    x = _as_tensor(imgs, device)
    rgb = x.dim() == 4
    b, h, w = (int(s) for s in x.shape[:3])
    ncomp = 3 if rgb else 1
    levels = capped_levels(h, w, levels)
    base_delta = float(base_delta)
    pack4 = ratio is not None and float(ratio) >= 400
    if pack4:
        pack8 = False
    k_fine = max(1, min(3, int(k_fine)))       # as the JAX package caps it
    meta = _AsyncMeta({'w': w, 'h': h, 'ncomp': ncomp, 'levels': levels,
                       'rgb': rgb, 'base_delta': base_delta,
                       'shifts': None})

    q = dwt97(x, levels, base_delta)
    layout = band_layout(levels, base_delta)
    nb = len(q[0])
    kmap = {}
    if pack4:
        k3, k7 = _pack4_sets(nb, levels)
        kmap = {k: k_fine for k in k3}
        kmap.update({k: 7 for k in k7})
    elif pack8:
        kmap = {k: 7 for k in range(nb - 3 * min(2, levels), nb)}
    small = []
    shipped = q
    if kmap:
        shifts = pack_shifts(q, kmap, layout)
        shipped = pack_apply(q, shifts, kmap)
        small.append(shifts)
    if pack4:
        shifts8 = pack_shifts(q, {k: 7 for k in k3}, layout)
        re8 = {k: [_requant(qb[k], shifts8[k], 7) for qb in q] for k in k3}
        small.append(shifts8)
        meta['kplanes'] = {k: k_fine for k in k3}
    del q
    host, ready = _copy_to_host([t for comp in shipped for t in comp]
                                + small)
    del shipped

    state = {'pages': None, 'err': None, 'shifts8': None}
    done = threading.Event()
    meta._event = done

    if pack4:
        cache = {}
        lock = threading.Lock()

        def refetch(k):
            """Band k at int8 (7 planes) for every page, fetched from the
            device only when rate allocation starves its plane budget."""
            with lock:
                if k not in cache:
                    done.wait()
                    if state['err'] is not None:
                        raise state['err']
                    cache[k] = ([a.cpu().numpy() for a in re8[k]],
                                int(state['shifts8'][k]))
                return cache[k]

        meta['refetch'] = refetch

    def _drain():
        try:
            if ready is not None:
                ready.synchronize()
            arrs = [t.numpy() for t in host]
            if kmap:
                meta['shifts'] = arrs[nb * ncomp].tolist()
            if pack4:
                state['shifts8'] = arrs[nb * ncomp + 1]
            comps = [arrs[c * nb:(c + 1) * nb] for c in range(ncomp)]
            state['pages'] = [[[a[i] for a in comp] for comp in comps]
                              for i in range(b)]
        except BaseException as exc:
            state['err'] = exc
        finally:
            done.set()

    threading.Thread(target=_drain, daemon=True,
                     name='jp2-qband-fetch').start()

    def fetch(i):
        done.wait()
        if state['err'] is not None:
            raise state['err']
        return state['pages'][i]

    return fetch, meta


def transform_jp2_batch(imgs, base_delta=1.0 / 64, levels=5, pack8=False,
                        ratio=None, k_fine=_PACK4_K_FINE, device=None):
    """Synchronous ``transform_jp2_batch_async``: (per_page_qbands,
    meta)."""
    fetch, meta = transform_jp2_batch_async(
        imgs, base_delta=base_delta, levels=levels, pack8=pack8,
        ratio=ratio, k_fine=k_fine, device=device)
    n = int(imgs.shape[0]) if hasattr(imgs, 'shape') else len(imgs)
    return [fetch(i) for i in range(n)], meta


def encode_jp2_tpu_batch(imgs, ratio=None, base_delta=1.0 / 64, levels=5,
                         workers=None, wrap_jp2=True, pack8=False,
                         k_fine=_PACK4_K_FINE, device=None):
    """Batched encode: uint8 (B, H, W) or (B, H, W, 3) -> a list of .jp2
    byte strings; one transform for the batch, then per-page Tier-1."""
    pages, meta = transform_jp2_batch(imgs, base_delta=base_delta,
                                      levels=levels, pack8=pack8,
                                      ratio=ratio, k_fine=k_fine,
                                      device=device)
    return [encode_jp2_from_qbands(p, meta, ratio=ratio, workers=workers,
                                   wrap_jp2=wrap_jp2, page_idx=i)
            for i, p in enumerate(pages)]


def encode_jp2_tpu(img, ratio=None, base_delta=1.0 / 64, levels=5,
                   workers=None, wrap_jp2=True, device=None):
    """Encode one uint8 image ((H, W) gray or (H, W, 3) RGB; numpy, sent
    to ``device``, or a tensor on its device) to JPEG2000.

    ratio: target compression ratio against the raw bytes, reached by
    PCRD pass truncation; None = no truncation.  base_delta: the finest
    band's quantiser step in DC-shifted units.  Returns .jp2 bytes (a
    raw codestream with wrap_jp2=False)."""
    lib = _get_lib()
    x = _as_tensor(img, device)
    rgb = x.dim() == 3
    h, w = (int(s) for s in x.shape[:2])
    ncomp = 3 if rgb else 1
    if workers is None:
        workers = min(8, os.cpu_count() or 1)
    levels = capped_levels(h, w, levels)
    qbands = [[q[0].cpu().numpy() for q in comp]
              for comp in dwt97(x[None], levels, float(base_delta))]
    return _host_encode(qbands, w, h, ncomp, levels, float(base_delta),
                        ratio, rgb, lib, workers, wrap_jp2)
