"""Threshold an image with the Sauvola kernel, optionally despeckle or
TV-denoise the mask, and save it: the port of the root tool
``tools/threshold-image``, with the same arguments plus ``--device``.

    python -m archive_pdf_tools_tpu_torch.tools.threshold_image IN OUT \\
        [--dpi N] [-k K] [--invert] [--denoise none|fast|bregman] \\
        [--device cuda:0|cpu]

On the card the threshold is the blur + Sauvola kernel with identity
taps (K3) and ``--denoise fast`` the despeckle kernel (K2); ``--device
cpu`` runs their plain versions.
"""

import argparse
import sys

import numpy as np
import torch
from PIL import Image

from ..ops.denoise_cuda import fast_mask_denoise
from ..ops.threshold_cuda import threshold_image
from ..ops.tv import denoise_bregman
from ..utils.backend import resolve_device


def device_argument(parser):
    """The ``--device`` option the port's tools share."""
    parser.add_argument('--device', default='cuda:0',
                        help="torch device (default cuda:0; 'cpu' runs the "
                             'plain PyTorch versions of the kernels)')


def read_mask(path):
    """A mask image as bool (H, W), True where set.  Pillow's mode '1'
    arrays hold True as the byte 255; the comparison makes each a
    canonical 1 before a kernel reads the bytes."""
    return np.asarray(Image.open(path).convert('1')) != 0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('infile')
    parser.add_argument('outfile')
    parser.add_argument('--dpi', type=int, default=None)
    parser.add_argument('-k', type=float, default=0.34)
    parser.add_argument('--invert', action='store_true')
    parser.add_argument('--denoise', choices=['none', 'fast', 'bregman'],
                        default='none')
    device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    img = Image.open(args.infile)
    if img.mode != 'L':
        img = img.convert('L')
    arr = np.asarray(img)
    if args.invert:
        arr = 255 - arr

    page = torch.from_numpy(np.array(arr[None])).to(device)
    mask = threshold_image(page, args.dpi, args.k)
    if args.denoise == 'fast':
        mask = fast_mask_denoise(mask, 4, 2)
    elif args.denoise == 'bregman':
        mask = denoise_bregman(mask)
    mask = mask[0].cpu().numpy()

    Image.fromarray(mask).save(args.outfile)
    print('wrote %s (ink fraction %.4f)' % (args.outfile, mask.mean()))
    return 0


if __name__ == '__main__':
    sys.exit(main())
