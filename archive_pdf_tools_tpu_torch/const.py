# Copied from archive_pdf_tools_tpu/const.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: the port's own PRODUCER.
"""Public constants, kept value-compatible with the reference CLI/API
surface (image mode ints, denoise/codec identifier strings, runtime
warning codes — reference internetarchivepdf/const.py)."""

VERSION = '0.1.0'
__version__ = VERSION

PRODUCER = ('Internet Archive PDF (PyTorch/CUDA) %s; torch MRC engine'
            % (VERSION,))
# the JAX package's engine name, which the XMP of a PDF it wrote
# carries (pipeline/recode.py swaps it for PRODUCER)
REFERENCE_PRODUCER = ('Internet Archive PDF (TPU) %s; jax/XLA MRC engine'
                      % (VERSION,))

# Image handling modes for recode()'s pass 2.  MRC is the flagship;
# passthrough/pixmap re-use the source PDF's images; skip emits
# text-only pages.
(IMAGE_MODE_PASSTHROUGH,
 IMAGE_MODE_PIXMAP,
 IMAGE_MODE_MRC,
 IMAGE_MODE_SKIP) = range(4)

# Mask despeckle strategies.
DENOISE_NONE, DENOISE_FAST, DENOISE_BREGMAN = 'none', 'fast', 'bregman'

# Non-fatal runtime warnings surfaced by recode() in its errors set.
_WARNING_CODES = ('invalid-page-size', 'invalid-page-numbers',
                  'invalid-jp2-headers', 'too-small-to-downsample')
(RECODE_RUNTIME_WARNING_INVALID_PAGE_SIZE,
 RECODE_RUNTIME_WARNING_INVALID_PAGE_NUMBERS,
 RECODE_RUNTIME_WARNING_INVALID_JP2_HEADERS,
 RECODE_RUNTIME_WARNING_TOO_SMALL_TO_DOWNSAMPLE) = _WARNING_CODES
RECODE_RUNTIME_WARNINGS = set(_WARNING_CODES)

# JPEG2000 backend identifiers (codecs/jpeg2000.py dispatch).
JPEG2000_IMPL_KAKADU = 'kakadu'
JPEG2000_IMPL_OPENJPEG = 'openjpeg'
JPEG2000_IMPL_GROK = 'grok'
JPEG2000_IMPL_PILLOW = 'pillow'
JPEG2000_IMPL_TPU = 'tpu'       # in-tree encoder (device DWT + C++ T1)
JPEG2000_IMPLS = (JPEG2000_IMPL_KAKADU, JPEG2000_IMPL_OPENJPEG,
                  JPEG2000_IMPL_GROK, JPEG2000_IMPL_PILLOW,
                  JPEG2000_IMPL_TPU)

# fg/bg layer codecs and mask codecs.
COMPRESSOR_JPEG2000, COMPRESSOR_JPEG = 'jpeg2000', 'jpeg'
COMPRESSOR_JBIG2, COMPRESSOR_CCITT = 'jbig2', 'ccitt'
