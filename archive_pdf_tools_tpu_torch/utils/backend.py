"""Device helpers shared by the kernel wrappers.

There is no global backend switch: every kernel wrapper dispatches on
the device of the tensor it is given.  A CPU tensor runs the plain
PyTorch version; a CUDA tensor launches the hand-written kernel or
raises.
"""

import numpy as np
import torch


def resolve_device(device=None):
    """The torch device the pipeline runs on.  ``None`` means the first
    GPU; there is no silent fall-back to the CPU — pass ``'cpu'`` for
    that explicitly."""
    dev = torch.device('cuda:0' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass '
                           "device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device):
    """Wait for queued device work (stage timings read the host clock)."""
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def to_device(t, device):
    """A host tensor on ``device``.  To a GPU it goes from pinned memory,
    so the host need not wait for the device's queued work (a pageable
    copy may); the caching host allocator keeps the pinned buffer until
    the copy is done."""
    device = torch.device(device)
    if device.type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def pack_mask_bits(mask):
    """Pack a bool (B, H, W) mask to (B, H, ceil(W/8)) uint8 on its
    device, in np.unpackbits big-endian bit order (8x less
    device->host traffic for mask transfers)."""
    b, h, w = mask.shape
    wpad = -(-w // 8) * 8
    m = mask.to(torch.int32)
    if wpad != w:
        m = torch.nn.functional.pad(m, (0, wpad - w))
    m = m.reshape(b, h, wpad // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=mask.device)
    return (m * weights).sum(dim=-1).to(torch.uint8)


def unpack_mask_bits(packed, w):
    """Host-side inverse of pack_mask_bits -> bool numpy (..., H, w)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    bits = np.unpackbits(np.asarray(packed), axis=-1)
    return bits[..., :w].astype(bool)
