# Copied from archive_pdf_tools_tpu/validators/__init__.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Spec-driven conformance validators.

Independent checkers for the byte streams the framework emits — written
from the governing specifications (ITU-T T.88 for JBIG2, ITU-T T.800 /
ISO 15444-1 for JPEG2000, ISO 19005-3 + ISO 32000-1 for PDF/A-3b), NOT
from the in-tree encoders.  The reference relies on external consumers
(jbig2dec/mupdf-class viewers, veraPDF, kdu/opj) to keep its outputs
honest; none of those ship in this environment, so these modules fill
the same role: a second, independently-written implementation that the
encoders must satisfy.
"""

from .jbig2_check import validate_jbig2, Jbig2ValidationError  # noqa: F401
from .pdfa_check import validate_pdfa, PdfAValidationError  # noqa: F401
