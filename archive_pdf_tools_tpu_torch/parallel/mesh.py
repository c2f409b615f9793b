"""Page shards over torch devices: the counterpart of the JAX package's
``parallel/mesh.py``.

Pages are independent, so a batch splits over devices along its leading
(page) axis in contiguous slices, one a device.  A list of devices may
name one device more than once: one card, or the CPU, then runs two or
more shards in turn, which is how a split is checked without several
cards.  There is no mesh object: a shard is a tensor on its device, and
the per-shard functions (``parallel/sharded.py``) take lists of them.
"""

import torch

from ..utils.backend import resolve_device


def page_devices(n_devices=None, devices=None):
    """The devices a batch shards over (``page_mesh``): ``devices`` (any
    torch device names, repeats allowed), by default every visible CUDA
    device, cut to the first ``n_devices``."""
    if devices is None:
        devices = range(torch.cuda.device_count())
        if not devices:
            raise RuntimeError('page_devices: no CUDA device is visible; '
                               "name the devices, e.g. ['cpu', 'cpu']")
        devices = ['cuda:%d' % i for i in devices]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    return devices


def default_devices(device=None):
    """The devices a pipeline shards its batches over, from the device
    its caller asked for.  With none named (None), every visible card
    when more than one is visible (the JAX package's rule,
    ``pipeline/recode.py:324-338``), else the first GPU; a named device
    runs alone, so ``cuda:1`` never puts a shard on ``cuda:0``."""
    if device is None and torch.cuda.device_count() > 1:
        return page_devices()
    return [resolve_device(device)]


def split_devices(devices, batch):
    """``devices`` when a batch of ``batch`` pages splits evenly over
    them, else None: a batch smaller than the device count, or one that
    does not divide by it, runs on one device (the JAX package's rule,
    ``mrc/api.py:123-127``)."""
    if not devices or batch < len(devices) or batch % len(devices):
        return None
    return [torch.device(d) for d in devices]


def shard_pages(devices, *tensors):
    """Each tensor's contiguous leading-axis slices, slice i on
    ``devices[i]`` (a view where it is already there).  The leading axis
    must divide by the device count."""
    out = []
    for t in tensors:
        if t.shape[0] % len(devices):
            raise ValueError('shard_pages: %d pages do not split over %d '
                             'devices' % (t.shape[0], len(devices)))
        per = t.shape[0] // len(devices)
        out.append([t[i * per:(i + 1) * per].to(d)
                    for i, d in enumerate(devices)])
    return out if len(out) > 1 else out[0]


def replicate(devices, *tensors):
    """Each tensor on every device (a list a tensor)."""
    out = [[t.to(d) for d in devices] for t in tensors]
    return out if len(out) > 1 else out[0]


def gather_pages(shards, device):
    """The shards' pages, in shard order, as one tensor on ``device`` (a
    lone shard already there is returned as it is)."""
    device = torch.device(device)
    if len(shards) == 1 and shards[0].device == device:
        return shards[0]
    return torch.cat([s.to(device) for s in shards])
