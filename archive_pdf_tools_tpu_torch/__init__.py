"""archive-pdf-tools-tpu-torch: the MRC recode pipeline in PyTorch + CUDA.

A second package beside ``archive_pdf_tools_tpu`` (the JAX reference).
Module names mirror the JAX package so each counterpart is easy to find;
host-only modules (hOCR, codecs, PDF builder, validators) are imported
from the JAX package unchanged, and none of them imports jax.

    from archive_pdf_tools_tpu_torch import recode
"""

from archive_pdf_tools_tpu.const import VERSION, __version__  # noqa: F401

# stamped into Info /Producer and the XMP of every PDF the port writes
PRODUCER = ('Internet Archive PDF (PyTorch/CUDA) %s; torch MRC engine'
            % (VERSION,))


def recode(*args, **kwargs):
    """Lazy alias of pipeline.recode.recode (keeps import light)."""
    from .pipeline.recode import recode as _recode
    return _recode(*args, **kwargs)
