"""fg/bg radiate fill: wrapper of the hand-written CUDA kernel
``csrc/optimise.cu`` (the port of ``ops/optimise_pallas.py``).

A CPU tensor runs the plain PyTorch version (``ops/optimise.py``); a CUDA
tensor launches the kernel or raises.  ``optimise.launches`` counts the
calls that launch it (a parallel FIR pre-pass, then the row walk).

A row takes one CTA up to ``one_cta(n)`` columns, a thread block cluster
of up to ``MAX_CLUSTER`` CTAs up to ``max_width(n)``, and past that
strips of one CTA each that run as a wavefront through device memory
(``strips``): the card takes rows of any width.
"""

import ctypes

import torch

from ..utils import cudabuild
from .optimise import optimise as optimise_plain

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {'apt_optimise': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _P]}

COLS = 8                   # columns a thread of the row walk owns
MAX_THREADS = 1024         # threads of one CTA of the row walk
MAX_CLUSTER = 8            # CTAs a row may be split over (a cluster)
MAX_N = 22                 # FIR sum and count share one uint32 a pixel
SMEM = 227 * 1024          # shared memory a CTA may use
PAD = 32                   # colI halo columns a wavefront strip hands on


def pitch(w):
    """Columns of a strip of w: COLS columns a thread, whole warps."""
    return COLS * ((-(-w // COLS) + 31) // 32 * 32)


def walk_smem(q, n):
    """Shared bytes of a CTA of the row walk with a strip of q columns
    (q a pitch): 4 FIR rows in flight, two colI rows (32 halo columns, a
    spare word after every 8), two staged output rows, the reciprocal
    table, the last n output rows."""
    return (16 * q + 9 * (q + 32) + 2 * (q + 16)
            + 4 * (2048 + (n * n + 3) // 4 * 4) + n * q)


def one_cta(n):
    """The widest strip (a pitch) one CTA of the row walk holds at n."""
    q = COLS * MAX_THREADS
    while walk_smem(q, n) > SMEM:
        q -= COLS * 32
    return q


def strips(w, n):
    """The least number of CTAs a row of w columns is cut into at n, each
    strip at most ``one_cta(n)`` wide: a cluster up to MAX_CLUSTER, the
    wavefront past it."""
    return max(1, -(-w // one_cta(n)))


def max_width(n):
    """The widest row a cluster takes at n; wider rows run as the
    wavefront."""
    return MAX_CLUSTER * one_cta(n)


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
    n = int(n_size)
    if c > 4:
        raise ValueError('optimise: the CUDA kernel takes 1-4 channels, got '
                         '%d' % c)
    if not 1 <= n <= MAX_N:
        raise ValueError('optimise: the CUDA kernel takes n_size 1..%d, got '
                         '%d' % (MAX_N, n))
    k = strips(w, n)
    lib = cudabuild.load('optimise', _SIGNATURES)
    out = torch.empty_like(img)
    fir = torch.empty((b * c * h * k * pitch(-(-w // k)),),
                      dtype=torch.int32, device=img.device)
    # the wavefront's colI halo rows and progress flags
    wave = k > MAX_CLUSTER
    halo = torch.empty((b * c * k * h * PAD if wave else 0,),
                       dtype=torch.int32, device=img.device)
    flags = torch.empty((b * c * k if wave else 0,), dtype=torch.int32,
                        device=img.device)
    # RGB: the walk writes planes, a last kernel interleaves them
    planes = torch.empty((b * c * h * w,), dtype=torch.uint8,
                         device=img.device) if c > 1 else out
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.apt_optimise(img.data_ptr(), mask.data_ptr(),
                               fir.data_ptr(), planes.data_ptr(),
                               out.data_ptr(), halo.data_ptr() if wave
                               else None, flags.data_ptr() if wave else None,
                               b, h, w, c, n, k, stream)
    cudabuild.check(err, 'optimise')
    optimise.launches += 1
    return out


optimise.launches = 0
