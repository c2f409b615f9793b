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
not have, the control's layers against the reference's uncoded; under
``--bw-pdf``, the mask alone), and prints them beside their limits with
the judge's verdict (``judge.verdict``).  The benchmark's runs never run it.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Written:
    """The control's output in the place of a judged book: its masks, and
    (``images[i]``) page i's layers encoded by Pillow at the
    configuration's flags, for the Pillow configurations."""

    def __init__(self, batch, low, kws):
        self.batch, self.low, self.kws = batch, low, kws
        self.images = self

    def mask(self, i):
        return self.low[0][self.batch.index(i)]

    def __getitem__(self, i):
        from portbench import judge
        k = self.batch.index(i)
        return (None,) + tuple(
            _Raw(judge.encode_jpx(self.low[layer][k], self.kws[name]))
            for layer, name in ((1, 'fg'), (2, 'bg')))


class _Raw:
    def __init__(self, raw):
        self.raw = raw


def readings(book, config, seed, device):
    """{number: control's reading} of one book: ``judge.compare`` with the
    control's output as the judged book."""
    import numpy as np
    import torch
    from portbench import judge
    judge.check_config(config)
    _, batch, pages = judge.sample(seed, 1, judge.book_batches(book, config))
    ref = judge.reference_batch(book, config, batch, device)
    low = judge.reference_batch(book, config, batch, device,
                                ftype=torch.bfloat16, ftype64=np.float32)
    written = _Written(batch, low, config.get('pillow_layers'))
    # the in-tree coder's layers, which the reference cannot encode, are
    # compared uncoded
    decoded = {(i, layer): low[layer][batch.index(i)]
               for i in pages for layer in range(1, len(low))}
    return judge.compare(config, written, batch, pages, ref, decoded)


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
