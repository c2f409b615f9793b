"""archive-pdf-tools-tpu-torch: the MRC recode pipeline in PyTorch + CUDA.

A second package beside ``archive_pdf_tools_tpu`` (the JAX reference).
Module names mirror the JAX package so each counterpart is easy to find.
The port imports nothing of the JAX package: the host-only modules it
needs (PDF reading and writing, codecs, validators) are copies kept by
``tools/copy_shared.py``.

    from archive_pdf_tools_tpu_torch import recode
"""

# PRODUCER is stamped into Info /Producer and the XMP of every PDF the
# port writes
from .const import VERSION, PRODUCER, __version__  # noqa: F401


def recode(*args, **kwargs):
    """Lazy alias of pipeline.recode.recode (keeps import light)."""
    from .pipeline.recode import recode as _recode
    return _recode(*args, **kwargs)
