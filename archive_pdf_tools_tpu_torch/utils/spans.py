"""Spans: the port's one timing mechanism.

    with span('threshold', timing_data):
        ...

times a block on ``time.perf_counter_ns`` and, on exit, appends
``(name, seconds)`` to ``sink`` when one is given: the recode's timing
keys, which the ``--reporter``'s ``page_time_breakdown`` averages a page.

Tracing is on while a ``torch.profiler`` session is open anywhere in the
process.  The check is ``torch.autograd.profiler._is_profiler_enabled``,
a process-wide flag that reads True on every thread during a session;
``torch._C._autograd._profiler_enabled()`` is per thread and reads False
on the loader and the encode pool, so it is not used.  While tracing is
on, a span also

- opens ``torch.profiler.record_function(name)``, so that it sits in the
  session's trace, on the trace's clock, beside the kernels (a session
  that profiles only its own thread keeps only that thread's spans);
- appends a ``Record`` to this module's store on exit: its name, its
  id and its parent's (the innermost traced span open on the same
  thread), the thread's name and ident, the ``recode()`` call it belongs
  to, its start and end on ``perf_counter_ns``, and the thread's CPU
  time (``time.thread_time_ns``) spent in it.

``record`` stores a span that another process timed.

While tracing is off a span costs a clock pair, one flag read and the
sink's append.  The store holds at most ``CAP`` records and counts those
dropped past it; whoever traced reads it (``collected()``) and empties
it (``clear()``).

The ``recode()`` call a record belongs to is a per-thread value: ``call``
(the root span) numbers a call and binds its own thread to it; a thread
the call starts binds itself with ``bind(current_call())``, read on the
starting thread, so two calls on two threads never mix their threads.
"""

import itertools
import threading
import time
from collections import namedtuple

from torch.autograd import profiler as _profiler

Record = namedtuple('Record', 'id name parent thread thread_id call start_ns '
                              'end_ns cpu_ns')

CAP = 1 << 20

_lock = threading.Lock()
_store = []
_dropped = 0
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()


def tracing():
    """True while a torch.profiler session is open in the process."""
    return _profiler._is_profiler_enabled


def collected():
    """A copy of the store's records, in the order the spans ended."""
    with _lock:
        return list(_store)


def dropped():
    """Records not stored because the store held ``CAP``."""
    return _dropped


def clear():
    global _dropped
    with _lock:
        del _store[:]
        _dropped = 0


def current_call():
    """The id of the ``recode()`` call this thread works for, or None."""
    return getattr(_local, 'call', None)


def bind(call_id):
    """Bind this thread to a call: a loader or pool thread's first act,
    with the id its starting thread read."""
    _local.call = call_id


def record(name, thread, thread_id, start_ns, end_ns, cpu_ns):
    """Store, while tracing is on, a span timed outside this process (a
    decode in a worker process, on its ``perf_counter_ns``, which is
    CLOCK_MONOTONIC as this process's) under this thread's call, with the
    ``thread`` name and id given and no parent."""
    if _profiler._is_profiler_enabled:
        _append(Record(next(_ids), name, None, thread, thread_id,
                       current_call(), start_ns, end_ns, cpu_ns))


def _append(rec):
    global _dropped
    with _lock:
        if len(_store) < CAP:
            _store.append(rec)
        else:
            _dropped += 1


def _stack():
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class span:
    """Times a block; see the module's docstring.  ``start_ns`` is the
    span's start and ``elapsed()`` its seconds so far."""

    __slots__ = ('name', 'sink', 'start_ns', '_rf', '_id', '_parent', '_cpu')

    def __init__(self, name, sink=None):
        self.name = name
        self.sink = sink

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._open()
            self.start_ns = time.perf_counter_ns()
            self._cpu = time.thread_time_ns()
        else:
            self._rf = None
            self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._rf is None:
            end = time.perf_counter_ns()
        else:
            # the CPU interval lies inside the wall one: cpu <= wall
            cpu = time.thread_time_ns() - self._cpu
            end = time.perf_counter_ns()
            self._close(end, cpu)
        if self.sink is not None:
            self.sink.append((self.name, (end - self.start_ns) / 1e9))
        return False

    def elapsed(self):
        return (time.perf_counter_ns() - self.start_ns) / 1e9

    def _open(self):
        stack = _stack()
        self._parent = stack[-1] if stack else None
        self._id = next(_ids)
        stack.append(self._id)
        self._rf = _profiler.record_function(self.name)
        self._rf.__enter__()

    def _close(self, end, cpu):
        self._rf.__exit__(None, None, None)
        _stack().pop()
        th = threading.current_thread()
        _append(Record(self._id, self.name, self._parent, th.name, th.ident,
                       current_call(), self.start_ns, end, cpu))


class call(span):
    """The root span of one ``recode()`` call: numbers the call
    (``call_id``) and binds its thread to it while it is open."""

    __slots__ = ('call_id', '_outer')

    def __enter__(self):
        self.call_id = next(_calls)
        self._outer = current_call()
        _local.call = self.call_id
        return span.__enter__(self)

    def __exit__(self, *exc):
        try:
            return span.__exit__(self, *exc)
        finally:
            _local.call = self._outer
