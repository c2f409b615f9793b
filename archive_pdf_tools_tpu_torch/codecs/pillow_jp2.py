"""Pillow's JPEG2000 encode of one MRC layer (``-J pillow``).

``encode`` is the Pillow branch of ``codecs/mrc_encode.py``'s
``encode_mrc_img``.  Pillow's encoder runs openjpeg inside one C call
that holds the interpreter lock, so ``recode``'s encode pool sends each
layer to an encode worker process (``utils/workers.py`` ``ENCODERS``)
and waits for the codestream, which frees the lock of the process that
drives the card; every other caller encodes in its own thread.  Both
run this one function, so both give the same bytes.

This module imports nothing of torch: a worker process imports it,
``utils/workers.py``, numpy, Pillow and the port's
``codecs/jpeg2000.py`` only.
"""

import io

import numpy as np
from PIL import Image

from .jpeg2000 import _pillow_kwargs


def encode(array, flags):
    """The layer ``array`` (grey H x W or RGB H x W x 3, uint8) as a
    JPEG2000 codestream at Pillow's ``flags`` (``key:literal;...``, the
    first of a layer's compression flags)."""
    buf = io.BytesIO()
    Image.fromarray(np.asarray(array)).save(buf, format='JPEG2000',
                                            **_pillow_kwargs(flags))
    return buf.getvalue()
