"""Pillow's JPEG2000 encode of one MRC layer (``-J pillow``).

``encode`` is the Pillow branch of ``codecs/mrc_encode.py``'s
``encode_mrc_img``.  Pillow's encoder runs openjpeg inside one C call
that holds the interpreter lock, so ``recode``'s encode pool sends each
layer to an encode worker process (``pipeline/pageload.py``
``ENCODERS``) and waits for the codestream, which frees the lock of the
process that drives the card; every other caller encodes in its own
thread.  Both run this one function, so both give the same bytes.

This module imports nothing of torch: a worker process imports it,
numpy, Pillow and the port's ``codecs/jpeg2000.py`` only.
"""

import io
import os
import time

import numpy as np
from PIL import Image

from .jpeg2000 import _pillow_kwargs


def encode(array, flags):
    """The layer ``array`` (grey H x W or RGB H x W x 3, uint8) as a
    JPEG2000 codestream at Pillow's ``flags`` (``key:literal;...``, the
    first of a layer's compression flags).  Returns the bytes, then the
    encode's start and end on ``perf_counter_ns`` (CLOCK_MONOTONIC, the
    same clock in every process of the machine), its thread CPU time in
    ns, and this process's id."""
    start = time.perf_counter_ns()
    cpu = time.thread_time_ns()
    buf = io.BytesIO()
    Image.fromarray(np.asarray(array)).save(buf, format='JPEG2000',
                                            **_pillow_kwargs(flags))
    cpu = time.thread_time_ns() - cpu
    return buf.getvalue(), start, time.perf_counter_ns(), cpu, os.getpid()
