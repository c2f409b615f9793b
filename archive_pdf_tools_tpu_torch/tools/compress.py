"""fg/bg JPEG2000 compression of an image and a mask through the radiate
fills: the port of the root tool ``tools/compress``, with the same
arguments plus ``--device``.

    python -m archive_pdf_tools_tpu_torch.tools.compress IMAGE MASK PREFIX \\
        [--impl pillow|tpu] [--bg-flags F] [--fg-flags F] \\
        [--device cuda:0|cpu]

Writes PREFIX_fg.jp2 (fill n=3 on the mask) and PREFIX_bg.jp2 (n=10 on
its inverse); the fills are the fill kernel (K1), the encoders the
host's (``--impl tpu``: the in-tree encoder, its transform on the
device).
"""

import argparse
import sys

import numpy as np
import torch
from PIL import Image

from ..codecs.mrc_encode import encode_mrc_background, encode_mrc_foreground
from ..ops.optimise_cuda import optimise
from ..utils.backend import resolve_device
from .threshold_image import device_argument, read_mask


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('image')
    parser.add_argument('mask')
    parser.add_argument('out_prefix')
    parser.add_argument('--impl', default='pillow')
    parser.add_argument('--bg-flags',
                        default='quality_mode:"rates";quality_layers:[500]')
    parser.add_argument('--fg-flags',
                        default='quality_mode:"rates";quality_layers:[750]')
    device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    img = np.asarray(Image.open(args.image))
    mask = read_mask(args.mask)
    img = torch.from_numpy(np.array(img[None])).to(device)
    mask = torch.from_numpy(np.array(mask[None])).to(device)

    fg = optimise(mask, img, 3)[0].cpu().numpy()
    bg = optimise(~mask, img, 10)[0].cpu().numpy()

    ef = encode_mrc_foreground(fg, [args.fg_flags],
                               jpeg2000_implementation=args.impl,
                               device=device)
    eb = encode_mrc_background(bg, [args.bg_flags],
                               jpeg2000_implementation=args.impl,
                               device=device)
    with open(args.out_prefix + '_fg.jp2', 'wb') as fp:
        fp.write(ef.data)
    with open(args.out_prefix + '_bg.jp2', 'wb') as fp:
        fp.write(eb.data)
    print('wrote %s_fg.jp2 (%d bytes), %s_bg.jp2 (%d bytes)'
          % (args.out_prefix, len(ef.data), args.out_prefix, len(eb.data)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
