"""Ablation builds of the blur + Sauvola kernel (``csrc/blur_sauvola.cu``
built with ``-DAPT_ABLATE=...``), their wrapper and their plain PyTorch
versions.  They replace the TPU tool's ``tools/threshold_ablate.py:189``
``_build(ablate)``, and time the parts of the two-launch design apart
(``tools/threshold_ablate.py`` in this package).

What each variant returns is the TPU tool's:

- ``full``: the shipped kernel, the bool ink mask;
- ``no_vmac``: horizontal-only blur, truncated, then Sauvola (mask);
- ``no_hmac``: vertical-only blur, truncated, then Sauvola (mask);
- ``no_blur``: Sauvola on the raw page (mask);
- ``no_emit``: the uint8 blurred page (no window sums, no test);
- ``machinery``, ``u8ring``, ``passthru``: timing only, the uint8 page
  itself (the two launches' loads, staging, barriers and stores without
  the arithmetic; the same with the blur's vertical-pass tile held as
  uint8 in shared memory; one copy launch).

The plain versions use the shipped plain version's blur order
(``threshold_cuda``: vertical, then horizontal, taps ascending, no
folding) and ``sauvola_mask``.  A CPU tensor runs the plain version; a
CUDA tensor launches the variant's build or raises.
``blur_sauvola_ablate.launches`` counts launches per variant.
"""

import collections

import torch

from ..utils import cudabuild
from .sauvola import sauvola_mask
from .threshold_cuda import (_SIGNATURES, _check, launch, separable_blur,
                             vertical_pass, horizontal_pass, truncate_u8)

VARIANTS = ('full', 'no_emit', 'no_hmac', 'no_vmac', 'no_blur',
            'machinery', 'u8ring', 'passthru')
MASK_VARIANTS = ('full', 'no_hmac', 'no_vmac', 'no_blur')


def build(variant):
    """Build (if needed) and load the variant's library,
    ``build/libblur_sauvola.<variant>.so``."""
    return cudabuild.load('blur_sauvola', _SIGNATURES, variant=variant,
                          defines={'APT_ABLATE':
                                   'APT_ABL_' + variant.upper()})


def _plain_blur(img, taps, variant):
    x = img.to(torch.float32)
    if variant == 'no_vmac':
        return truncate_u8(horizontal_pass(x, taps))
    if variant == 'no_hmac':
        return truncate_u8(vertical_pass(x, taps))
    if variant == 'no_blur':
        return img
    return separable_blur(img, taps)


def blur_sauvola_ablate_plain(img, taps, window, variant, k=0.34, R=128.0):
    if variant in MASK_VARIANTS:
        return sauvola_mask(_plain_blur(img, taps, variant), window, window,
                            k, R)
    if variant == 'no_emit':
        return separable_blur(img, taps)
    return img.clone()


def blur_sauvola_ablate(img, taps, window, variant, k=0.34, R=128.0):
    """One ablation variant of blur + Sauvola on uint8 (B, H, W) pages
    with f32 (B, 2r+1) taps; see the module notes for what it returns."""
    if variant not in VARIANTS:
        raise ValueError('blur_sauvola_ablate: unknown variant %r'
                         % (variant,))
    _check(img, taps, window, k)
    if img.device.type == 'cpu':
        return blur_sauvola_ablate_plain(img, taps, window, variant, k, R)
    if img.device.type != 'cuda':
        raise ValueError('blur_sauvola_ablate: unsupported device %s'
                         % img.device)
    if not (img.is_contiguous() and taps.is_contiguous()):
        raise ValueError('blur_sauvola_ablate: inputs must be contiguous')
    lib = build(variant)
    out = torch.empty(img.shape, dtype=torch.bool if variant in MASK_VARIANTS
                      else torch.uint8, device=img.device)
    # the uint8 blurred page, where the variant's launches use it
    blur = None if variant in ('passthru', 'no_emit') \
        else torch.empty_like(img)
    err = launch(lib, img, taps, out, blur, window, k, R)
    cudabuild.check(err, 'blur_sauvola_ablate %s' % variant)
    blur_sauvola_ablate.launches[variant] += 1
    return out


blur_sauvola_ablate.launches = collections.Counter()
