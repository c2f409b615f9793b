# Copied from archive_pdf_tools_tpu/ops/golden.py:1-14 and :141-190 by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: estimate_sigma_np and its helpers only.
"""Reference-exact numpy oracles for the hot kernels.

These reproduce, in plain vectorized numpy, the *semantics* of the
reference's Cython kernels (``cython/sauvola.pyx``, ``cython/optimiser.pyx``)
including their C-integer-division quirks and sequential update order.
They exist so the JAX/TPU kernels can be validated against ground truth
without the reference being importable, and double as slow CPU fallbacks.

They are deliberately written in a different (vectorized, 2-D) style from
the reference's flat serial loops; only the mathematical contract is shared.
"""

import numpy as np


_DB2_LO = np.array([-0.12940952255092145, 0.22414386804185735,
                    0.836516303737469, 0.48296291314469025])
_DB2_HI = np.array([-0.48296291314469025, 0.836516303737469,
                    -0.22414386804185735, -0.12940952255092145])
_MAD_DENOM = 0.6744897501960817


def pywt_dwt1d(a, filt, axis):
    """pywt-exact single-level 1-D DWT pass (float64): symmetric
    half-sample extension, ``y[o] = sum_j filt[j] * x_sym[2o+1-j]``,
    output length ``(n + F - 1) // 2`` — the conventions of pywt's
    ``downsampling_convolution`` with MODE_SYMMETRIC, validated against
    the documented db1 dwt examples."""
    k = np.asarray(filt, np.float64)[::-1]
    L = len(k)
    a = np.moveaxis(np.asarray(a, np.float64), axis, -1)
    n = a.shape[-1]
    ap = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(L - 2, L - 1)],
                mode='symmetric')
    nout = (n + L - 1) // 2
    out = np.zeros(a.shape[:-1] + (nout,))
    for j in range(L):
        out += k[j] * ap[..., j:j + 2 * nout:2][..., :nout]
    return np.moveaxis(out, -1, axis)


def pywt_dwt2_db2(x):
    """pywt.dwt2(x, 'db2', mode='symmetric') bands as (aa, ad, da, dd),
    axes applied in pywt.dwtn order (axis 0, then axis 1)."""
    lo0 = pywt_dwt1d(x, _DB2_LO, -2)
    hi0 = pywt_dwt1d(x, _DB2_HI, -2)
    return (pywt_dwt1d(lo0, _DB2_LO, -1), pywt_dwt1d(lo0, _DB2_HI, -1),
            pywt_dwt1d(hi0, _DB2_LO, -1), pywt_dwt1d(hi0, _DB2_HI, -1))


def estimate_sigma_np(img):
    """skimage ``estimate_sigma`` ground truth: pywt-exact db2 diagonal
    detail, zeros dropped, ``median(|dd|) / Phi^-1(0.75)``."""
    dd = pywt_dwt1d(pywt_dwt1d(np.asarray(img, np.float64),
                               _DB2_HI, -2), _DB2_HI, -1)
    flat = np.abs(dd).ravel()
    nz = flat[flat > 0]
    if nz.size == 0:
        return 0.0
    return float(np.median(nz) / _MAD_DENOM)


# ---------------------------------------------------------------------------
# fast mask despeckle (optimiser.pyx:436-472 semantics)
# ---------------------------------------------------------------------------
