"""The decode of an image-stack page.

``decode_page`` is the image-stack branch of ``recode``'s page load: a
JPEG2000 file decoded (at a reduced resolution under ``--downsample``),
any other file read by Pillow, RGBA and LA flattened, and under
``--downsample`` a non-JPEG2000 page shrunk by a LANCZOS thumbnail.

``recode``'s loader decodes the next pages ahead of the one it batches.
Pillow's JPEG2000 decoder reads its input through a Python file object
and holds the interpreter lock while it decodes, so a JPEG2000 page
decodes in a worker process (``in_process``; ``decode_packed`` on
``utils/workers.py``'s ``WORKERS``, ``jp2_decode_width()`` processes),
where it frees the lock of the process that drives the card; every
other format's decoder mostly releases the lock, so such a page decodes
on a thread (``decode_width()`` of them) and is not copied between
processes.

This module imports nothing of torch: a decode worker imports it,
``utils/workers.py``, Pillow and the port's ``const`` and
``codecs/jpeg2000.py`` only.
"""

from PIL import Image

from ..codecs.jpeg2000 import decode_jpeg2000
from ..const import JPEG2000_IMPL_PILLOW

JPEG2000_SUFFIXES = ('.jp2', '.jpx')


def decode_page(path, downsample=None, impl=JPEG2000_IMPL_PILLOW,
                threads=None, debug=False):
    """One image-stack page as the recode batches it (``recode.py``'s
    image load, ``:318-372``): ``--downsample`` reduces a JPEG2000 file in
    the decoder and shrinks any other page with a LANCZOS thumbnail."""
    downsampled = False
    if path.endswith(JPEG2000_SUFFIXES):
        image = decode_jpeg2000(path, reduce_=downsample, impl=impl,
                                threads=threads, debug=debug)
        downsampled = bool(downsample)
    else:
        image = Image.open(path)
        image.load()
    image = flatten(image)
    if downsample is not None and not downsampled:
        w, h = image.size
        image.thumbnail((w / downsample, h / downsample),
                        resample=Image.LANCZOS, reducing_gap=None)
    return image


def flatten(image):
    """RGBA as RGB and LA as L: the alpha channel is dropped."""
    if image.mode == 'RGBA':
        return image.convert('RGB')
    if image.mode == 'LA':
        return image.convert('L')
    return image


def in_process(path):
    """Whether the page decodes in a worker process: a JPEG2000 file,
    whose decoder holds the interpreter lock."""
    return path.endswith(JPEG2000_SUFFIXES)


def decode_packed(path, downsample, impl, threads, debug):
    """``decode_page`` in a worker process: the page as ``(mode, size,
    pixel bytes)`` for ``Image.frombytes``."""
    image = decode_page(path, downsample, impl, threads, debug)
    if image.mode not in ('1', 'L', 'RGB'):
        # as the loader would: a palette does not survive the bytes
        image = image.convert('RGB')
    return image.mode, image.size, image.tobytes()
