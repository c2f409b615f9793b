# Copied from archive_pdf_tools_tpu/utils/nativebuild.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: makes the .so's directory.
"""Race-free on-demand builds of the in-tree native .so files.

The encode pool dlopens these lazily from multiple threads (and the
test runner / bench may do so from multiple processes).  A plain
``g++ -o lib.so`` in ``_get_lib`` races: one thread dlopens the file
while another g++ is still writing it ("file too short", observed
2026-08-19 on the e2e bench).  Builds therefore go to a unique temp
file and are published with an atomic ``os.replace``, serialized by a
per-path thread lock plus an ``fcntl`` file lock for cross-process
safety.
"""

import fcntl
import os
import subprocess
import threading

_locks = {}
_locks_guard = threading.Lock()


def _path_lock(path):
    with _locks_guard:
        if path not in _locks:
            _locks[path] = threading.Lock()
        return _locks[path]


def _stale(so_path, srcs):
    if not os.path.exists(so_path):
        return True
    mt = os.path.getmtime(so_path)
    return any(mt < os.path.getmtime(s) for s in srcs)


def ensure_so(so_path, srcs, flag_sets):
    """Build ``so_path`` from ``srcs`` if missing or older than any
    source.  ``flag_sets`` is a list of g++ flag lists tried in order
    (for optional-ISA fallbacks, e.g. with/without -mfma).  Returns the
    path, guaranteed to be a fully written .so."""
    if not _stale(so_path, srcs):
        return so_path
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    with _path_lock(so_path):
        lockfile = so_path + '.lock'
        with open(lockfile, 'w') as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                if not _stale(so_path, srcs):  # built while we waited
                    return so_path
                tmp = '%s.tmp.%d' % (so_path, os.getpid())
                last = None
                try:
                    for flags in flag_sets:
                        try:
                            subprocess.check_call(
                                ['g++'] + list(flags)
                                + ['-shared', '-o', tmp] + list(srcs))
                            break
                        except subprocess.CalledProcessError as exc:
                            last = exc
                    else:
                        raise last if last is not None else \
                            RuntimeError('ensure_so: empty flag_sets for %s'
                                         % so_path)
                    os.replace(tmp, so_path)
                finally:
                    if os.path.exists(tmp):   # failed build leftovers
                        os.unlink(tmp)
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)
    return so_path
