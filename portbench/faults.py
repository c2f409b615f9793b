"""Faults planted in the program, and the judge's numbers on its output
with each: the readings that the limits of ``correct`` are set above
(``sound``, the program as it is) and below (a fault).

    python3 -m portbench.faults --workload <name> --seeds <n>[,<n>...] \
        [--faults sound,b7_zero,...]

For each seed it makes the cell's book, and for each fault recodes it
once, as the window does, with the fault planted in this process, then
judges that book (``judge.judge``) and prints one JSON line: the numbers
beside their limits and ``correct``.  The faults (``FAULTS``) replace a
function of the program by one that breaks it:

    mask_altered         a block of the batch's first mask inverted
    mask_half            the second half of the batch's masks left empty
    despeckle_unchanged  the despeckle returns the mask it was given
    fill_unchanged       the layer fills return the page unfilled
    b7_zero              the wavelet's bands are zeros (never written)
    quant_step           the bands quantised with twice the step that
                         the codestream states
    t1_drop_ll           Tier-1 codes no block of the lowest resolution
    page_inverted        (``--bw-pdf``) each mask-only page written with
                         its black and white swapped
    extra_image          (``--bw-pdf``) each mask-only page given its
                         image twice

The benchmark's runs never run it; ``portbench/tests/test_portbench_run.py``
and ``test_portbench_flags.py`` plant the same faults in a tiny run.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _masks(fault):
    import archive_pdf_tools_tpu_torch.pipeline.recode as recode_mod
    real = recode_mod.decompose_masks

    def masks(*args, **kw):
        mask, imgs = real(*args, **kw)
        mask = mask.clone()
        if fault == 'mask_altered':
            mask[0, 10:20, 10:30] = ~mask[0, 10:20, 10:30]
        else:
            mask[mask.shape[0] // 2:] = False
        return mask, imgs
    return recode_mod, 'decompose_masks', masks


def _despeckle():
    import archive_pdf_tools_tpu_torch.mrc.api as api
    return api, 'sharded_denoise', lambda masks, mode, exact=True: masks


def _fill():
    import archive_pdf_tools_tpu_torch.mrc.api as api
    return api, 'sharded_optimise', \
        lambda masks, images, n, invert=False: list(images)


def _dwt(fault):
    import torch
    import archive_pdf_tools_tpu_torch.codecs.jp2tpu as jp2tpu
    real = jp2tpu.dwt97

    def dwt97(imgs, levels, base_delta):
        if fault == 'quant_step':
            return real(imgs, levels, 2.0 * base_delta)
        return tuple(tuple(torch.zeros_like(b) for b in comp)
                     for comp in real(imgs, levels, base_delta))
    return jp2tpu, 'dwt97', dwt97


def _tier1():
    import numpy as np
    import archive_pdf_tools_tpu_torch.codecs.jp2tpu as jp2tpu
    real = jp2tpu.encode_jp2_from_qbands

    def encode(page_qbands, meta, **kw):
        page_qbands = [[np.zeros_like(b) if k == 0 else b
                        for k, b in enumerate(comp)] for comp in page_qbands]
        return real(page_qbands, meta, **kw)
    return jp2tpu, 'encode_jp2_from_qbands', encode


def _bw_page(fault):
    from archive_pdf_tools_tpu_torch.pdf.builder import DocumentBuilder
    real = DocumentBuilder.insert_raw_mask_page

    def insert(self, page_idx, mask_enc):
        if fault == 'page_inverted':
            return real(self, page_idx, mask_enc._replace(
                decode=None if mask_enc.decode else (1, 0)))
        real(self, page_idx, mask_enc)
        return real(self, page_idx, mask_enc)
    return DocumentBuilder, 'insert_raw_mask_page', insert


FAULTS = {
    'sound': None,
    'mask_altered': lambda: _masks('mask_altered'),
    'mask_half': lambda: _masks('mask_half'),
    'despeckle_unchanged': _despeckle,
    'fill_unchanged': _fill,
    'b7_zero': lambda: _dwt('b7_zero'),
    'quant_step': lambda: _dwt('quant_step'),
    't1_drop_ll': _tier1,
    'page_inverted': lambda: _bw_page('page_inverted'),
    'extra_image': lambda: _bw_page('extra_image'),
}


@contextlib.contextmanager
def plant(fault):
    """The program with ``fault`` planted, for the ``with`` block."""
    if FAULTS[fault] is None:
        yield
        return
    mod, name, fn = FAULTS[fault]()
    real = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, real)


def readings(book, config, seed, fault, path, device):
    """(checks, correct, recode seconds) of one book recoded with
    ``fault`` planted."""
    from archive_pdf_tools_tpu_torch.pipeline.recode import recode
    from portbench import judge
    from portbench.run import recode_kwargs
    t = time.time()
    with plant(fault), contextlib.redirect_stdout(sys.stderr):
        recode(out_pdf=path, **recode_kwargs(config, book, device))
    took = time.time() - t
    checks, correct = judge.judge(book, config, [path], judge.sha256(path),
                                  seed, device)
    return checks, correct, took


def main(argv=None, root=ROOT):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--faults', default=','.join(FAULTS))
    args = ap.parse_args(argv)
    import torch
    from portbench.registry import Benchmark
    from portbench.run import cache_env
    from portbench.traffic.generator import make_book
    bench = Benchmark(root)
    wl = bench.workload(args.workload)
    config = bench.config(wl['config'])
    spec = bench.traffic(wl['traffic'])
    cache_env(root)
    if not torch.cuda.is_available():
        print('faults: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda:0')
    for seed in (int(s) for s in args.seeds.split(',')):
        tmp = tempfile.mkdtemp(prefix='portbench-faults-')
        try:
            book = make_book(spec, seed, os.path.join(tmp, 'book'),
                             cache_dir=os.path.join(root, 'portbench',
                                                    '.build', 'pages'))
            for fault in args.faults.split(','):
                path = os.path.join(tmp, fault + '.pdf')
                checks, correct, took = readings(book, config, seed, fault,
                                                 path, device)
                print(json.dumps({'workload': args.workload, 'seed': seed,
                                  'fault': fault, 'correct': correct,
                                  'recode_s': took,
                                  'checks': {k: {'value': v, 'limit': lim}
                                             for k, (v, lim)
                                             in checks.items()}}))
                sys.stdout.flush()
                os.remove(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
