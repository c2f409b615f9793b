"""The host's workers: one core count and every pool's width drawn from
it, the worker processes, the thread pools bound to a ``recode()`` call,
and the timing of work done in a worker process.

The widths: ``jp2_decode_width()`` the JPEG2000 decode processes
(``WORKERS``), ``decode_width()`` the decode threads of other pages,
``encode_width(threads)`` the encode pool's threads and the ``-J
pillow`` encode processes (``ENCODERS``), ``tier1_width(threads)`` the
Tier-1 band threads of one layer's encode.

A ``threads=`` given to ``recode()`` sets the encode pool's width and
the Tier-1 band threads'; the decoders and external coders get it as it
is given.

A worker process imports this module (``timed`` runs there), so it
imports nothing of torch; ``utils/spans.py``, which does, is imported
in the functions that run in the parent.  The workers start by
``spawn`` (the parent holds a CUDA context and threads, which ``fork``
would copy), so like every ``spawn`` child they import the parent's main
script under ``__mp_main__``: a script that calls ``recode`` on JPEG2000
pages or with ``-J pillow`` runs its work under
``if __name__ == '__main__'``.
"""

import atexit
import functools
import multiprocessing
import os
import threading
import time
from collections import namedtuple
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from concurrent.futures.process import BrokenProcessPool


def cores():
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:   # no affinity call on this platform
        return os.cpu_count() or 1


def decode_width():
    """Decode threads, for an image stack's pages that are not JPEG2000:
    half the cores, 1-4."""
    return min(4, max(1, cores() // 2))


def jp2_decode_width():
    """JPEG2000 decode processes (``WORKERS``): the cores, at most 8, one
    batch at the default ``--batch-pages``.  A process a core beats
    openjpeg's own threads: the code-stream parse and the read through
    Pillow's file object do not split over threads."""
    return min(8, cores())


def encode_width(threads=None):
    """Encode pool threads: ``threads`` (at least 1) when it is set, else,
    as for the encode processes, the cores, 2-4."""
    if threads:
        return max(1, threads)
    return min(4, max(2, cores()))


def tier1_width(threads=None):
    """Tier-1 band threads: ``threads`` when it is set, else the cores,
    at most 8."""
    return min(8, cores()) if threads is None else threads


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


# apart: in one queue the decodes ahead would wait behind two-second
# encodes, or the encodes behind the decodes
WORKERS = Workers(jp2_decode_width)
ENCODERS = Workers(encode_width)
atexit.register(WORKERS.shutdown)
atexit.register(ENCODERS.shutdown)


def binding():
    """A function that binds the thread which runs it to the calling
    thread's ``recode()`` call."""
    from . import spans
    return functools.partial(spans.bind, spans.current_call())


def bound_threads(prefix, width):
    """A pool of ``width`` threads ``<prefix>_<n>``, bound to the calling
    thread's ``recode()`` call."""
    return ThreadPoolExecutor(max_workers=width, thread_name_prefix=prefix,
                              initializer=binding())


# the value, then its start and end on ``perf_counter_ns``
# (CLOCK_MONOTONIC, one clock for every process of the machine), its
# thread CPU time in ns, and the worker's process id
Timed = namedtuple('Timed', 'value start_ns end_ns cpu_ns pid')


def timed(fn, *args):
    """``fn(*args)``, timed in the worker process that runs it."""
    start = time.perf_counter_ns()
    cpu = time.thread_time_ns()
    value = fn(*args)
    cpu = time.thread_time_ns() - cpu
    return Timed(value, start, time.perf_counter_ns(), cpu, os.getpid())


def take(done, name, thread):
    """The value of ``done``, a ``Timed``; while tracing, its span is
    stored as a record ``name`` on thread ``<thread>-<pid>`` under the
    calling thread's ``recode()`` call."""
    from . import spans
    spans.record(name, '%s-%d' % (thread, done.pid), done.pid,
                 done.start_ns, done.end_ns, done.cpu_ns)
    return done.value
