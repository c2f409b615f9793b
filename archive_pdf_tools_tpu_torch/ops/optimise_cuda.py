"""fg/bg radiate fill: wrapper of the hand-written CUDA kernel
``csrc/optimise.cu`` (the port of ``ops/optimise_pallas.py``).

A CPU tensor runs the plain PyTorch version (``ops/optimise.py``); a CUDA
tensor launches the kernel or raises.  ``optimise.launches`` counts the
kernel launches.
"""

import ctypes

import torch

from ..utils import cudabuild
from .optimise import optimise as optimise_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {'apt_optimise': [_P, _P, _P, _I, _I, _I, _I, _I, _P]}

# 3 int32 column arrays per row walk in at most 227 KB of shared memory
MAX_WIDTH = (227 * 1024) // 12


def _check(mask, img):
    if mask.dtype != torch.bool or img.dtype != torch.uint8:
        raise TypeError('optimise: need bool mask and uint8 img, got %s, %s'
                        % (mask.dtype, img.dtype))
    if mask.dim() != 3 or img.dim() not in (3, 4) \
            or tuple(img.shape[:3]) != tuple(mask.shape):
        raise ValueError('optimise: mask (B,H,W) and img (B,H,W[,C]) '
                         'shapes differ: %s vs %s'
                         % (tuple(mask.shape), tuple(img.shape)))
    if mask.device != img.device:
        raise ValueError('optimise: mask on %s, img on %s'
                         % (mask.device, img.device))


def optimise(mask, img, n_size):
    """mask: bool (B, H, W); img: uint8 (B, H, W) or (B, H, W, C).
    Returns uint8 of img's shape (see ops/optimise.py)."""
    _check(mask, img)
    if img.device.type == 'cpu':
        return optimise_plain(mask, img, n_size)
    if img.device.type != 'cuda':
        raise ValueError('optimise: unsupported device %s' % img.device)
    if not (mask.is_contiguous() and img.is_contiguous()):
        raise ValueError('optimise: inputs must be contiguous')
    b, h, w = mask.shape
    c = 1 if img.dim() == 3 else img.shape[3]
    if w > MAX_WIDTH:
        raise ValueError('optimise: width %d exceeds the kernel limit %d'
                         % (w, MAX_WIDTH))
    lib = cudabuild.load('optimise', _SIGNATURES)
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.apt_optimise(img.data_ptr(), mask.data_ptr(),
                               out.data_ptr(), b, h, w, c, int(n_size),
                               stream)
    cudabuild.check(err, 'optimise')
    optimise.launches += 1
    return out


optimise.launches = 0
