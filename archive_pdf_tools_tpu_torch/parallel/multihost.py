"""Multi-host page-range sharding: the counterpart of the JAX package's
``parallel/multihost.py``.

Pages are independent, so several hosts split a book by work, not by
collectives: each host takes a contiguous page range, recodes it on its
own cards (``recode(devices=...)`` shards its batches within the host)
and writes per-page artifacts (``out_dir``, the files ``--resume``
reads).  One host then gathers the artifact directories and assembles
the PDF with ``recode(..., resume=True, out_dir=merged)``.  Only the
artifact gather crosses hosts.

``init_distributed`` starts ``torch.distributed`` (gloo) for callers
that want a process group; the page split itself needs none.
"""

import math
import os
import shutil


def init_distributed(coordinator=None, num_processes=None, process_id=None):
    """``torch.distributed.init_process_group`` (gloo) from explicit
    arguments or torch's standard environment variables: ``coordinator``
    'host:port' (``MASTER_ADDR`` and ``MASTER_PORT``), ``num_processes``
    (``WORLD_SIZE``) and ``process_id`` (``RANK``).  A no-op returning
    False for a single process; True once the group is up."""
    if coordinator is None and 'MASTER_ADDR' in os.environ:
        coordinator = '%s:%s' % (os.environ['MASTER_ADDR'],
                                 os.environ.get('MASTER_PORT', '29500'))
    if coordinator is None:
        return False
    num_processes = int(num_processes or os.environ.get('WORLD_SIZE', '1'))
    process_id = int(process_id or os.environ.get('RANK', '0'))
    if num_processes <= 1:
        return False
    import torch.distributed as dist
    dist.init_process_group('gloo', init_method='tcp://' + coordinator,
                            world_size=num_processes, rank=process_id)
    return True


# copy_shared: archive_pdf_tools_tpu/parallel/multihost.py:41-91
def assign_page_range(n_pages, n_hosts, host_id):
    """Contiguous [start, stop) page range for this host.  Contiguous
    (not strided) so each host's batches keep same-shape pages from the
    same book region together, and artifact directories stay dense."""
    if not 0 <= host_id < n_hosts:
        raise ValueError('host_id %d out of range for %d hosts'
                         % (host_id, n_hosts))
    per = math.ceil(n_pages / n_hosts)
    start = min(host_id * per, n_pages)
    stop = min(start + per, n_pages)
    return start, stop


def host_stop_after(n_pages, n_hosts, host_id):
    """Map a page range onto recode()'s skip/stop knobs: returns
    (skip_pages list, stop_after) reproducing assign_page_range inside
    the unmodified pipeline."""
    start, stop = assign_page_range(n_pages, n_hosts, host_id)
    return list(range(0, start)), stop - start


def gather_artifacts(host_dirs, merged_dir):
    """Merge per-host artifact directories into one directory for the
    final assembly host to consume with
    ``recode(..., resume=True, out_dir=merged_dir)``.

    host_dirs: list of ``dir`` or ``(dir, page_offset)``.  Each host's
    artifacts (``%.6d_{mask.*,bg.jp2,fg.jp2,meta.json}``) are keyed by
    that host's *local* builder page index (its pass 1 skipped earlier
    pages), so pass each host's global range start as page_offset to
    renumber into the merged global index space.  Later directories win
    on collisions (reruns)."""
    os.makedirs(merged_dir, exist_ok=True)
    n = 0
    for entry in host_dirs:
        d, offset = entry if isinstance(entry, tuple) else (entry, 0)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            src = os.path.join(d, name)
            if not os.path.isfile(src) or '_' not in name:
                continue
            idx_s, rest = name.split('_', 1)
            try:
                idx = int(idx_s)
            except ValueError:
                continue
            dst = os.path.join(merged_dir, '%.6d_%s' % (idx + offset, rest))
            shutil.copy2(src, dst)
            n += 1
    return n
# copy_shared: end
