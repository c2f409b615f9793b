"""Ablation profile of the blur + Sauvola kernel (K3) on one GPU.

Times the ablation builds of ``csrc/blur_sauvola.cu``
(``ops/threshold_ablate_cuda.py``): the same launches with parts switched
off, so the differences localise the kernel's cost.

  full       the shipped kernel
  no_emit    the Sauvola walk skipped (blur only)
  no_hmac    horizontal MAC skipped (vertical-only blur)
  no_vmac    vertical MAC skipped (horizontal-only blur)
  no_blur    both MACs skipped (Sauvola on the raw page)
  machinery  the two launches' loads, staging, barriers and stores only
  u8ring     machinery with the blur's vertical-pass tile held as uint8
             in shared memory in place of float32
  passthru   one copy launch: the floor

Pages as the TPU tool ``tools/threshold_ablate.py`` makes them: a seed-0
random uint8 batch of 3300x2550, window 101, radius 4 gaussian taps of
sigma 1.5.  Each variant is called once (build and first launch:
"compiled"), then ``reps`` rounds over all variants, each call timed
with CUDA events.  Needs a CUDA device and never falls back to the CPU;
at batch 32 it holds ~4 GB on the card.

Usage: python -m archive_pdf_tools_tpu_torch.tools.threshold_ablate
       [batch] [reps]
"""

import sys

import numpy as np
import torch

from ..ops.threshold_ablate_cuda import VARIANTS, blur_sauvola_ablate

H, W, WINDOW, RADIUS = 3300, 2550, 101, 4


def _timed(fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    batch = int(argv[0]) if len(argv) > 0 else 32
    reps = int(argv[1]) if len(argv) > 1 else 5
    if not torch.cuda.is_available():
        print('threshold_ablate: no CUDA device (this tool times the '
              'kernels on the card only)', file=sys.stderr)
        return 1
    dev = torch.device('cuda:0')

    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.integers(0, 256, (batch, H, W),
                                        dtype=np.uint8)).to(dev)
    g = np.exp(-0.5 * (np.arange(-RADIUS, RADIUS + 1) / 1.5) ** 2)
    taps = np.zeros((batch, 2 * RADIUS + 1), np.float32)
    taps[:] = (g / g.sum()).astype(np.float32)
    taps = torch.from_numpy(taps).to(dev)

    def call(v):
        return lambda: blur_sauvola_ablate(img, taps, WINDOW, v)

    runs = {v: [] for v in VARIANTS}
    for v in VARIANTS:
        call(v)()
        torch.cuda.synchronize()
        print('%9s compiled' % v, flush=True)
    for _ in range(reps):
        for v in VARIANTS:
            runs[v].append(_timed(call(v)))
    for v in VARIANTS:
        t = sorted(runs[v])
        print('%9s  best %6.1f ms  median %6.1f ms' % (
            v, t[0], t[len(t) // 2]), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
