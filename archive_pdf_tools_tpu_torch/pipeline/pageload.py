"""The decode of an image-stack page, and the worker processes that run
it and Pillow's layer encode.

``decode_page`` is the image-stack branch of ``recode``'s page load: a
JPEG2000 file decoded (at a reduced resolution under ``--downsample``),
any other file read by Pillow, RGBA and LA flattened, and under
``--downsample`` a non-JPEG2000 page shrunk by a LANCZOS thumbnail.

``recode``'s loader decodes the next pages ahead of the one it batches.
Pillow's JPEG2000 decoder reads its input through a Python file object
and holds the interpreter lock while it decodes, so a JPEG2000 page
decodes in a worker process (``in_process``), where it frees the lock
of the process that drives the card; every other format's decoder
mostly releases the lock, so such a page decodes on a thread and is not
copied between processes.

``recode``'s encode pool sends each ``-J pillow`` JPEG2000 layer to the
encode workers (``ENCODERS``, ``codecs/pillow_jp2.py``), a pool of their
own: in one queue the decodes ahead would wait behind two-second
encodes, or the encodes behind the decodes.

This module imports nothing of torch: a decode worker imports it,
Pillow and the port's ``const`` and ``codecs/jpeg2000.py`` only, and an
encode worker ``codecs/pillow_jp2.py``, numpy, Pillow and
``codecs/jpeg2000.py``.  The workers start by ``spawn`` (the parent
holds a CUDA context and threads, which ``fork`` would copy), so like
every ``spawn`` child they import the parent's main script under
``__mp_main__``: a script that calls ``recode`` on JPEG2000 pages or
with ``-J pillow`` runs its work under ``if __name__ == '__main__'``.
"""

import atexit
import multiprocessing
import os
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool

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


def decode_width():
    """Decode workers (processes or threads) for this process: half the
    cores it may run on, at least 1 and at most 4; the other half is the
    encode pool's, the host Tier-1 coder's and the main thread's."""
    try:
        cores = len(os.sched_getaffinity(0))
    except AttributeError:   # no affinity call on this platform
        cores = os.cpu_count() or 1
    return min(4, max(1, cores // 2))


def encode_width():
    """Encode workers (``recode``'s encode pool threads, and the
    processes that run their ``-J pillow`` layers): the host's cores, at
    least 2 and at most 4.  A ``threads=`` that widens the pool leaves
    the processes at this width."""
    return min(4, max(2, os.cpu_count() or 4))


def decode_packed(path, downsample, impl, threads, debug):
    """``decode_page`` in a worker process.  Returns the page as
    ``(mode, size, pixel bytes)`` for ``Image.frombytes``, then the
    decode's start and end on ``perf_counter_ns`` (CLOCK_MONOTONIC, the
    same clock in every process of the machine), its thread CPU time in
    ns, and this process's id."""
    start = time.perf_counter_ns()
    cpu = time.thread_time_ns()
    image = decode_page(path, downsample, impl, threads, debug)
    if image.mode not in ('1', 'L', 'RGB'):
        # as the loader would: a palette does not survive the bytes
        image = image.convert('RGB')
    data = image.tobytes()
    cpu = time.thread_time_ns() - cpu
    return (image.mode, image.size, data, start, time.perf_counter_ns(),
            cpu, os.getpid())


class Workers:
    """A pool of ``width()`` worker processes: started on the first
    submit and kept across ``recode()`` calls (starting them costs about
    a second, once), started anew on the submit after one died (the
    executor is then broken), shut down at interpreter exit."""

    def __init__(self, width):
        self._width = width
        self._lock = threading.Lock()
        self._pool = None

    def submit(self, fn, *args):
        with self._lock:
            if self._pool is not None:
                try:
                    return self._pool.submit(fn, *args)
                except BrokenProcessPool:
                    self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = ProcessPoolExecutor(
                self._width(),
                mp_context=multiprocessing.get_context('spawn'))
            return self._pool.submit(fn, *args)

    def shutdown(self):
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


WORKERS = Workers(decode_width)
ENCODERS = Workers(encode_width)
atexit.register(WORKERS.shutdown)
atexit.register(ENCODERS.shutdown)
