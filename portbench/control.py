"""The control of ``correct``: the plain reference put in the program's
place and computed one precision lower than the configuration states
(bfloat16 for its float32 stages, float32 for its float64 one).  It has
to come out as not correct.

    python3 -m portbench.control --workload <name> --seeds <n>[,<n>...]

For each seed it makes the cell's book, draws the judged batch and pages
as a run with one book does, reads the numbers the judge compares from
the control's output in place of the written book (the mask share that
differs from the reference's; for Pillow layers the gap between the
control's layers and the reference's, each encoded by Pillow at the
configuration's flags; for the in-tree coder, which the reference does
not have, the control's layers against the reference's uncoded), and
prints them beside their limits with the judge's verdict
(``judge.verdict``).  The benchmark's runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(book, config, seed, device):
    """{number: control's reading} of one book."""
    import numpy as np
    import torch
    from portbench import judge
    _, batch, pages = judge.sample(seed, 1, judge.book_batches(book, config))
    ref = judge.reference_batch(book, config, batch, device)
    low = judge.reference_batch(book, config, batch, device,
                                ftype=torch.bfloat16, ftype64=np.float32)
    out = {'mask_mismatch': float((low[0] != ref[0]).mean())}
    kws = config.get('pillow_layers')
    if kws is None:
        for i in pages:
            k = batch.index(i)
            for name, layer in (('fg_err', 1), ('bg_err', 2)):
                err = judge.mean_abs(low[layer][k], ref[layer][k])
                out[name] = max(out.get(name, 0.0), err)
    else:
        for i in pages:
            k = batch.index(i)
            for name, layer, kw in (('fg_gap', 1, kws['fg']),
                                    ('bg_gap', 2, kws['bg'])):
                raw = judge.encode_jpx(low[layer][k], kw)
                gap = judge.layer_gap(raw, ref[layer][k], kw)
                out[name] = max(out.get(name, 0.0), gap)
    return out


def main(argv=None, root=ROOT, device=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    args = ap.parse_args(argv)
    import torch
    from portbench import judge
    from portbench.registry import Benchmark
    from portbench.run import cache_env
    from portbench.traffic.generator import make_book
    bench = Benchmark(root)
    wl = bench.workload(args.workload)
    config = bench.config(wl['config'])
    spec = bench.traffic(wl['traffic'])
    cache_env(root)
    if device is None:
        if not torch.cuda.is_available():
            print('control: no CUDA device', file=sys.stderr)
            return 2
        device = 'cuda:0'
    for seed in (int(s) for s in args.seeds.split(',')):
        tmp = tempfile.mkdtemp(prefix='portbench-control-')
        try:
            book = make_book(spec, seed, os.path.join(tmp, 'book'),
                             cache_dir=os.path.join(root, 'portbench',
                                                    '.build', 'pages'))
            checks, correct = judge.verdict(
                readings(book, config, seed, torch.device(device)), config)
            print(json.dumps({'workload': args.workload, 'seed': seed,
                              'correct': correct,
                              'checks': {k: {'value': v, 'limit': lim}
                                         for k, (v, lim) in checks.items()}}))
            sys.stdout.flush()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
