"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Set-up: the book is made from the seed (its pages written once into
``portbench/.build/pages/`` in worker processes, while this process
imports the port and opens the CUDA context, then linked in the seed's
order); then one recode of the book at the cell's flags warms the
kernels (building them on a checkout's first run).  The window is a closed loop of whole-book
``recode()`` calls on ``cuda:0``, each to a new PDF, started until
``--seconds`` have passed and ended when the book in flight is written,
so it holds at least one book and overruns by at most one.  With
``--trace 1`` the window runs under ``torch.profiler`` (CPU and CUDA) with
a span a book, and the recode reports its timing keys to a reporter
command that appends them to a file.

After the window the peak device memory is read, the program's state
freed, and the judge (``judge.py``) holds the written books against the
plain reference.  The last stdout line is the result, a JSON object; the
numbers compared are the last lines of stderr and the result's last key.
Exit codes: 0 with a result, 2 without the cards the cell needs, 3 when
the process holds a module of JAX or of the JAX package, 1 on a crash.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this directory heads sys.path; the checkout's root
# takes its place, so that no module here shadows another by its name
if sys.path and os.path.abspath(sys.path[0] or '.') == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# top-level module names that may not be loaded in the result's process
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'archive_pdf_tools_tpu')
# the output's timestamps are pinned, so a book's bytes never depend on
# when it was written (reproducible-builds convention)
SOURCE_DATE_EPOCH = '1700000000'
REPORTER = ['sh', '-c', 'cat >> "$0" && echo >> "$0"']
# the timing keys printed for each book of a traced run
BOOK_KEYS = ('image_load', 'fg_jp2', 'bg_jp2', 'mask_jbig2', 'threshold',
             'fast_denoise', 'page_image_insertion')


def forbidden_modules():
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_env(root):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, 'portbench', '.build')
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(build, 'torch_extensions'))
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(build, 'triton'))
    os.environ['SOURCE_DATE_EPOCH'] = SOURCE_DATE_EPOCH
    os.environ['USE_FLAX'] = '0'


class Run:
    """What the metric readers read: the window's books and their pages,
    times, reports and trace."""

    def __init__(self, book, recode_flags, device_kind):
        self.book = book
        self.recode_flags = recode_flags
        self.device_kind = device_kind
        self.pdfs = []
        self.reports = []
        self.trace = None
        self.setup_s = None
        self.window_s = None

    @property
    def pages(self):
        return len(self.pdfs) * self.book.pages

    def breakdown_ms(self, keys):
        """ms a page of the given timing keys, summed, over the window's
        pages (None when no report holds any of them)."""
        total, pages, seen = 0.0, 0, False
        for count, bd in self.reports:
            total += sum(bd.get(k, 0) for k in keys) * count
            pages += count
            seen = seen or any(k in bd for k in keys)
        return total / pages if seen and pages else None

    def work(self):
        """(bytes, operations) of the window's pages (``roofline.py``)."""
        from portbench import roofline
        nb = ops = 0
        for i in range(self.book.pages):
            b, o = roofline.page_work(self.book.shapes[i], self.book.boxes[i],
                                      self.book.spec['noise_sigma'],
                                      self.recode_flags)
            nb += b
            ops += o
        return nb * len(self.pdfs), ops * len(self.pdfs)


def recode_kwargs(config, book, device):
    """The arguments of the window's ``recode()`` calls, less the output
    path and the reporter."""
    return dict(config['recode'], from_imagestack=book.glob,
                hocr_file=book.hocr, resume=False, device=device)


def read_reports(path):
    """(pages, page_time_breakdown) of each book's final report."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if line:
                msg = json.loads(line)
                if 'page_time_breakdown' in msg:
                    out.append((msg['compress_pages']['count'],
                                msg['page_time_breakdown']))
    return out


def run_cell(workload, seed, seconds, trace, root=ROOT, device=None,
             out=None, err=None):
    """One run of a cell; returns the exit code.  ``device=None`` is the
    card ``cuda:0`` (and the check that the cell's cards are there); tests
    pass ``'cpu'`` to drive the rest of a run on the plain path."""
    out = out or sys.stdout
    err = err or sys.stderr
    from portbench.registry import Benchmark
    from portbench.traffic.generator import BookMaker

    bench = Benchmark(root)
    wl = bench.workload(workload)
    config = bench.config(wl['config'])
    spec = bench.traffic(wl['traffic'])
    metrics = bench.metrics(trace, wl['name'])
    cache_env(root)
    tmp = tempfile.mkdtemp(prefix='portbench-')
    maker = BookMaker(spec, seed, os.path.join(tmp, 'book'),
                      cache_dir=os.path.join(root, 'portbench', '.build',
                                             'pages'))
    try:
        return _run(wl, config, metrics, seed, seconds, trace, device, tmp,
                    maker, out, err)
    finally:
        maker.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _run(wl, config, metrics, seed, seconds, trace, device, tmp, maker,
         out, err):
    import torch
    from portbench import judge
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(wl['chips']):
            print('portbench: %s needs %d CUDA device(s); %d visible'
                  % (wl['name'], wl['chips'],
                     torch.cuda.device_count() if torch.cuda.is_available()
                     else 0), file=err)
            return 2
        device = 'cuda:0'
    dev = torch.device(device)
    from archive_pdf_tools_tpu_torch.pipeline.recode import recode
    if dev.type == 'cuda':
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = 'cpu'
    book = maker.wait()
    flags = dict(config['recode'])
    kwargs = recode_kwargs(config, book, device)

    def one_book(path, reporter=None):
        with contextlib.redirect_stdout(err):
            recode(out_pdf=path, reporter=reporter, **kwargs)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    warm = os.path.join(tmp, 'warm.pdf')
    one_book(warm)
    warm_sha = judge.sha256(warm)
    run = Run(book, flags, kind)
    run.setup_s = time.time() - T_START

    report_path = os.path.join(tmp, 'reports.jsonl')
    reporter = REPORTER + [report_path] if trace else None
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if dev.type == 'cuda':
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    failed = 0
    book_s = []
    with prof:
        t0 = time.time()
        while True:
            tb = time.time()
            path = os.path.join(tmp, 'book_%04d.pdf' % len(run.pdfs))
            with torch.profiler.record_function('book %d' % len(run.pdfs)):
                try:
                    one_book(path, reporter)
                except Exception as exc:   # the run goes on to report it
                    print('portbench: recode raised %r' % (exc,), file=err)
                    failed = book.pages
                    break
            run.pdfs.append(path)
            book_s.append(time.time() - tb)
            if time.time() - t0 >= seconds:
                break
        run.window_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()
    if trace:
        from portbench.trace import Trace
        tpath = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(tpath)
        run.trace = Trace.load(tpath)
        os.remove(tpath)
        run.reports = read_reports(report_path)
    del prof

    t_judge = time.time()
    if failed or not run.pdfs:
        checks, correct = {}, False
    else:
        checks, correct = judge.judge(book, config, run.pdfs, warm_sha,
                                      seed, dev)
    for k, (count, bd) in enumerate(run.reports):
        # what moves one book against another in the run
        print('portbench: book %d, ms a page: %s' % (k, ', '.join(
            '%s %.1f' % (key, bd[key]) for key in BOOK_KEYS if key in bd)),
            file=err)
    print('portbench: set-up %.3f s, window %.3f s (%d books: %s s), '
          'judge %.3f s' % (run.setup_s, run.window_s, len(run.pdfs),
                            ' '.join('%.3f' % b for b in book_s),
                            time.time() - t_judge), file=err)
    values = {}
    for name, (entry, reader) in metrics.items():
        v = reader.read(run) if run.pdfs else None
        if v is not None:
            values[name] = {'value': v, 'unit': entry['unit']}
    device_info = {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
                   'kind': kind, 'count': int(wl['chips']),
                   'memory_peak_bytes': int(peak)}
    result = {'correct': bool(correct),
              'attempted': run.pages + failed,
              'failed': failed,
              'metrics': values,
              'device': device_info}
    if trace and run.trace is not None:
        device_info['busy_s'] = run.trace.busy_s()
        device_info['window_s'] = run.trace.window_s
        result['breakdown'] = {'device_ops': run.trace.by_kernel(),
                               'idle_gaps': run.trace.idle_gaps()}
    result['checks'] = {k: {'value': v, 'limit': lim}
                        for k, (v, lim) in checks.items()}
    bad = forbidden_modules()
    if bad:
        print('portbench: the process holds %s; no result' % ', '.join(bad),
              file=err)
        return 3
    for k, (v, lim) in checks.items():
        print('check %s %r limit %r' % (k, v, lim), file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    return run_cell(args.workload, args.seed, args.seconds, bool(args.trace))


if __name__ == '__main__':
    sys.exit(main())
