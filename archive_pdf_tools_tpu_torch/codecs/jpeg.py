# Copied from archive_pdf_tools_tpu/codecs/jpeg.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""JPEG codec with jpegoptim-style size targeting.

The reference's ``--mrc-image-format jpeg`` path saves a quality-100
JPEG and pipes it through ``jpegoptim -S<kb> --stdout`` (``mrc.py:560-570``).
jpegoptim's -S mode re-encodes at descending quality until the output
fits the byte budget; we reproduce that in-process with Pillow using a
binary search over quality (identical contract: output <= target size,
highest quality that fits; plain max-quality optimize when no target).

A system jpegoptim, when present, can be preferred for byte parity.
"""

import io
import re
import subprocess
from shutil import which


def _size_target_kb(flags):
    """Extract -S<kb> from jpegoptim-style flag list."""
    for f in flags or []:
        m = re.match(r'^-S(\d+)$', f)
        if m:
            return int(m.group(1))
        m = re.match(r'^--size=(\d+)$', f)
        if m:
            return int(m.group(1))
    return None


def encode_jpeg(img, flags=None, debug=False):
    """PIL image -> JPEG bytes honoring a jpegoptim -S size target."""
    target_kb = _size_target_kb(flags)

    def enc(quality):
        buf = io.BytesIO()
        img.save(buf, format='JPEG', quality=quality, optimize=True)
        return buf.getvalue()

    if target_kb is None:
        return enc(95)

    target = target_kb * 1024
    lo, hi = 1, 95
    best = enc(lo)
    if len(best) > target:
        return best          # can't fit; lowest quality wins (as jpegoptim)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        data = enc(mid)
        if len(data) <= target:
            best, lo = data, mid
        else:
            hi = mid - 1
    return best


def jpegoptim_available():
    return which('jpegoptim') is not None


def encode_jpeg_external(img, flags, debug=False):
    """Byte-parity path through a system jpegoptim (``mrc.py:560-570``)."""
    buf = io.BytesIO()
    img.save(buf, format='JPEG', quality=100)
    args = ['jpegoptim'] + list(flags or []) + ['--stdin', '--stdout']
    proc = subprocess.run(args, input=buf.getvalue(),
                          stdout=subprocess.PIPE, check=True)
    return proc.stdout
