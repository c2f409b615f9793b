"""Exact mask despeckle: wrapper of the hand-written CUDA kernel
``csrc/despeckle.cu`` (the port of ``ops/denoise_pallas.py``).

A CPU tensor runs the plain PyTorch version (``ops/denoise.py``); a CUDA
tensor launches the kernel or raises.  ``fast_mask_denoise.launches``
counts the calls that launch it (a bit packing pass, the row walk, the
unpacking pass).

One CTA walks a page up to ``max_width()`` columns; a wider page is cut
into ``strips(w)`` strips of one CTA each that run as a wavefront through
device memory, so the card takes pages of any width.
"""

import ctypes

import torch

from ..utils import cudabuild
from .denoise import fast_mask_denoise_exact

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {'apt_despeckle': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}

# one CTA of <= 1024 threads a page, each owning 1 or 2 words of 32
# columns (the kernel's WPT)
MAX_THREADS = 1024
MAX_WPT = 2


def strips(w):
    """The CTAs a row of w columns is cut into: one up to ``max_width()``,
    past it strips of at most MAX_THREADS words (the wavefront)."""
    words = -(-w // 32)
    return 1 if words <= MAX_WPT * MAX_THREADS else -(-words // MAX_THREADS)


def walk_layout(w):
    """(threads, words a thread) of a CTA of the row walk for w columns:
    one word a thread up to 32,768 columns, two up to 65,536; past that
    one word a thread of each of ``strips(w)`` strips; threads in whole
    warps."""
    words = -(-w // 32)
    k = strips(w)
    if k > 1:
        return -(-(-(-words // k)) // 32) * 32, 1
    wpt = 1 if words <= MAX_THREADS else MAX_WPT
    return -(-words // (32 * wpt)) * 32, wpt


def max_width():
    """The widest page one CTA walks; wider pages run as the wavefront."""
    return 32 * MAX_WPT * MAX_THREADS


def fast_mask_denoise(mask, mincnt=4, n_size=2):
    """Exact sequential despeckle of a bool (B, H, W) mask (reference
    call ``mrc.py:388`` uses mincnt=4, n_size=2)."""
    if mask.dtype != torch.bool or mask.dim() != 3:
        raise TypeError('fast_mask_denoise: need a bool (B, H, W) mask, '
                        'got %s %s' % (mask.dtype, tuple(mask.shape)))
    if mask.device.type == 'cpu':
        return fast_mask_denoise_exact(mask, mincnt, n_size)
    if mask.device.type != 'cuda':
        raise ValueError('fast_mask_denoise: unsupported device %s'
                         % mask.device)
    if n_size != 2:
        raise ValueError('fast_mask_denoise: the CUDA kernel implements '
                         'n_size=2, got %d' % n_size)
    if not mask.is_contiguous():
        raise ValueError('fast_mask_denoise: mask must be contiguous')
    b, h, w = mask.shape
    lib = cudabuild.load('despeckle', _SIGNATURES)
    out = torch.empty_like(mask)
    # the packed input and the final bit rows, a word per 32 columns
    threads, wpt = walk_layout(w)
    k = strips(w)
    words = k * threads * wpt
    bits = torch.empty((2 * b * h * words,), dtype=torch.int32,
                       device=mask.device)
    # the wavefront's edge words and progress flags
    halo = torch.empty((2 * b * k * h if k > 1 else 0,), dtype=torch.int32,
                       device=mask.device)
    flags = torch.empty((2 * b * k if k > 1 else 0,), dtype=torch.int32,
                        device=mask.device)
    with torch.cuda.device(mask.device):
        stream = torch.cuda.current_stream(mask.device).cuda_stream
        err = lib.apt_despeckle(mask.data_ptr(), bits.data_ptr(),
                                halo.data_ptr() if k > 1 else None,
                                flags.data_ptr() if k > 1 else None,
                                out.data_ptr(), b, h, w, int(mincnt), stream)
    cudabuild.check(err, 'fast_mask_denoise')
    fast_mask_denoise.launches += 1
    return out


fast_mask_denoise.launches = 0
