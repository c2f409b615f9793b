"""Run the radiate fill or the partial blurs on an image and a mask: the
port of the root tool ``tools/partial-blur``, with the same arguments
plus ``--device``.

    python -m archive_pdf_tools_tpu_torch.tools.partial_blur IMAGE MASK \\
        OUT [--mode optimise|gaussian|box] [-n N] [--invert-mask] \\
        [--device cuda:0|cpu]

``--mode optimise`` is the fill kernel (K1); ``gaussian`` and ``box`` are
``ops/filters.py``'s torch ops.
"""

import argparse
import sys

import numpy as np
import torch
from PIL import Image

from ..ops.filters import partial_blur, partial_boxblur
from ..ops.optimise_cuda import optimise
from ..utils.backend import resolve_device
from .threshold_image import device_argument, read_mask


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('image')
    parser.add_argument('mask')
    parser.add_argument('outfile')
    parser.add_argument('--mode', choices=['optimise', 'gaussian', 'box'],
                        default='optimise')
    parser.add_argument('-n', type=int, default=3,
                        help='optimise window / blur size')
    parser.add_argument('--invert-mask', action='store_true')
    device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    img = np.asarray(Image.open(args.image))
    mask = read_mask(args.mask)
    if args.invert_mask:
        mask = ~mask
    img = torch.from_numpy(np.array(img[None])).to(device)
    mask = torch.from_numpy(np.array(mask[None])).to(device)

    if args.mode == 'optimise':
        out = optimise(mask, img, args.n)
    elif args.mode == 'gaussian':
        out = partial_blur(mask, img, sigma=args.n)
    else:
        out = partial_boxblur(mask, img, size=args.n)
    Image.fromarray(out[0].cpu().numpy()).save(args.outfile)
    print('wrote %s' % args.outfile)
    return 0


if __name__ == '__main__':
    sys.exit(main())
