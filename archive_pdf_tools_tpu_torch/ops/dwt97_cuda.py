"""JPEG2000 forward transform (DC shift / ICT, 9/7 DWT, quantiser):
wrapper of the hand-written CUDA kernel ``csrc/dwt97.cu`` (the port of
the JAX package's ``codecs/jp2tpu.py:_device_transform``), with its plain
PyTorch version in ``ops/dwt97.py``.

The kernel makes one launch a level over tiles of ``TILE`` output
samples with a halo of ``HALO`` each side (``tiles`` is its plan), so a
page of any width is taken.  A CPU tensor runs the plain version; a CUDA
tensor launches the kernel or raises.  ``dwt97.launches`` counts the
calls that launch it.
"""

import ctypes

import numpy as np
import torch

from ..codecs.jp2host import _band_shapes, band_layout
from ..utils import cudabuild
from .dwt97 import dwt97 as dwt97_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {'apt_dwt97': [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                             ctypes.POINTER(ctypes.c_float), _I, _I, _P]}

MAX_LEVELS = 32
# output rows and columns of a CTA's tile (even; the loaded tile, with
# the halo, is 64 x 128 float32, 32 KB), and the halo: a low sample of a
# 9/7 level reads the input 4 samples away, a high one 3
TILE = (56, 120)
HALO = 4


def tiles(n, tile, halo=HALO):
    """The kernel's tiling of one axis of a level's region of n samples:
    (start, end, load_start, load_end) of each tile's outputs and of the
    span it loads, clamped to [0, n)."""
    return [(s, min(s + tile, n), max(s - halo, 0), min(s + tile + halo, n))
            for s in range(0, n, tile)]


def _check(imgs, levels):
    if imgs.dtype != torch.uint8:
        raise TypeError('dwt97: need uint8 pixels, got %s' % imgs.dtype)
    if not (imgs.dim() == 3 or (imgs.dim() == 4 and imgs.shape[3] == 3)):
        raise ValueError('dwt97: need (B, H, W) or (B, H, W, 3), got %s'
                         % (tuple(imgs.shape),))
    if min(imgs.shape[:3]) < 1:
        raise ValueError('dwt97: empty batch or page %s'
                         % (tuple(imgs.shape),))
    if not 1 <= int(levels) <= MAX_LEVELS:
        raise ValueError('dwt97: levels %d outside 1..%d'
                         % (levels, MAX_LEVELS))


def dwt97(imgs, levels, base_delta):
    """uint8 (B, H, W) gray or (B, H, W, 3) RGB -> one tuple per
    component of the 3L+1 int32 (B, bh, bw) quantised bands in
    codestream order, on the input's device (see ops/dwt97.py)."""
    _check(imgs, levels)
    levels = int(levels)
    if imgs.device.type == 'cpu':
        return dwt97_plain(imgs, levels, base_delta)
    if imgs.device.type != 'cuda':
        raise ValueError('dwt97: unsupported device %s' % imgs.device)
    if not imgs.is_contiguous():
        raise ValueError('dwt97: input must be contiguous')
    b, h, w = (int(s) for s in imgs.shape[:3])
    ncomp = 1 if imgs.dim() == 3 else 3
    lib = cudabuild.load('dwt97', _SIGNATURES)
    inv = (ctypes.c_float * (3 * levels + 1))(
        *[float(np.float32(1.0 / m[5]))
          for m in band_layout(levels, float(base_delta))])
    shapes = _band_shapes(w, h, levels)
    sizes = [bh * bw * b for bh, bw in shapes]
    # the float32 LL planes of odd and of even levels, each level's input
    # the next
    ll = [torch.empty((b * ncomp * (-(-h // 2 ** k)) * (-(-w // 2 ** k))
                       if levels > k else 0,), dtype=torch.float32,
                      device=imgs.device) for k in (1, 2)]
    out = torch.empty(sum(sizes) * ncomp, dtype=torch.int32,
                      device=imgs.device)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream(imgs.device).cuda_stream
        err = lib.apt_dwt97(imgs.data_ptr(), ll[0].data_ptr(),
                            ll[1].data_ptr(), out.data_ptr(), b, h, w,
                            ncomp, levels, inv, TILE[0], TILE[1], stream)
    cudabuild.check(err, 'dwt97')
    dwt97.launches += 1
    # out holds band by band (codestream order) the (ncomp, B, bh, bw)
    # blocks; each component's band is a view
    comps = [[] for _ in range(ncomp)]
    pos = 0
    for (bh, bw), n in zip(shapes, sizes):
        for c in range(ncomp):
            comps[c].append(out[pos:pos + n].view(b, bh, bw))
            pos += n
    return tuple(tuple(c) for c in comps)


dwt97.launches = 0
