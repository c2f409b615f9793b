"""The page decode ahead of the loader (``pipeline/pageload.py``,
``utils/workers.py`` ``WORKERS`` and ``recode._pages_ahead``): JPEG2000
pages in worker processes, other pages on decode threads, equal to the
in-process load, in page order, with the old exceptions, no thread left
behind, no torch in a worker, and a JPEG2000 book byte-identical with
the JAX package's recode."""

import concurrent.futures
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch
from concurrent.futures.process import BrokenProcessPool
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from archive_pdf_tools_tpu.const import PRODUCER as JAX_PRODUCER
from archive_pdf_tools_tpu_torch.pdf import builder as port_builder
from archive_pdf_tools_tpu_torch.pipeline import pageload
from archive_pdf_tools_tpu_torch.pipeline import recode as port_recode
from archive_pdf_tools_tpu_torch.utils import spans
from archive_pdf_tools_tpu_torch.utils import workers as port_workers
from tests.fixtures import HOCR_TEMPLATE, render_book_page, words_to_hocr_page

torch.set_num_threads(2)

W, H = 240, 312


def _pixels(mode, seed=0):
    img, _ = render_book_page(W, H, seed=seed, noise=8, rgb=mode != 'L')
    im = Image.fromarray(img)
    if mode in ('RGBA', 'LA'):
        alpha = Image.fromarray(
            np.random.default_rng(seed).integers(0, 256, (H, W), np.uint8))
        im = im.convert(mode[:-1])
        im.putalpha(alpha)
    return im


def _save(im, path):
    if path.endswith('.jp2'):
        im.save(path, irreversible=True, quality_mode='rates',
                quality_layers=[10])
    else:
        im.save(path)
    return path


def _book(tmp_path, exts, words=True):
    """A page per extension (page 1 RGB), with hOCR; the glob of its
    pages."""
    hocr = []
    for i, ext in enumerate(exts):
        img, wds = render_book_page(W, H, seed=i, noise=0, rgb=i == 1)
        Image.fromarray(img).save(str(tmp_path / ('page_%04d.%s' % (i, ext))))
        hocr.append(words_to_hocr_page(wds if words else [], W, H,
                                       page_no=i, dpi=100))
    path = tmp_path / 'book.hocr'
    path.write_text(HOCR_TEMPLATE % '\n'.join(hocr), encoding='utf-8')
    return dict(from_imagestack=str(tmp_path / 'page_*'), hocr_file=str(path),
                dpi=100, jbig2=True)


def _ahead(paths, downsample=None, sink=None):
    return list(port_recode._pages_ahead(
        paths, downsample, 'pillow', None, False,
        sink if sink is not None else []))


def _leftover_threads():
    return [t.name for t in threading.enumerate()
            if t.name == 'loader' or t.name.startswith('decode_')]


@pytest.mark.parametrize('ext,mode,downsample', [
    ('jp2', 'L', None), ('jp2', 'RGB', None), ('png', 'RGBA', None),
    ('png', 'LA', None), ('jp2', 'RGB', 3), ('png', 'L', 2)])
def test_decode_ahead_equals_in_process_load(tmp_path, ext, mode,
                                             downsample):
    paths = [_save(_pixels(mode, seed=i),
                   str(tmp_path / ('p%d.%s' % (i, ext)))) for i in range(3)]
    sink = []
    got = _ahead(paths, downsample, sink)
    for i, image in enumerate(got):
        want = port_recode._load_page_image(None, paths, i, downsample,
                                            'pillow', None, False, None)
        assert want.mode in ('L', 'RGB')
        assert (image.mode, image.size) == (want.mode, want.size)
        assert image.tobytes() == want.tobytes()
    if downsample:
        assert got[0].size[0] < W
    assert [k for k, _ in sink] == ['image_load'] * 3
    assert all(s > 0 for _, s in sink)
    assert not _leftover_threads()


def test_book_keeps_page_order_when_decodes_end_in_reverse(tmp_path,
                                                           monkeypatch):
    """Decodes made to end last page first: the batches hold the same
    pages, keys and order, and the book the same bytes."""
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    kw = _book(tmp_path, ['png'] * 5)
    batches = []
    real_masks = port_recode.decompose_masks

    def masks(pages, words, dpi=None, **k):
        batches.append([(np.asarray(p).shape, dpi) for p in pages])
        return real_masks(pages, words, dpi=dpi, **k)

    monkeypatch.setattr(port_recode, 'decompose_masks', masks)
    port_recode.recode(out_pdf=str(tmp_path / 'a.pdf'), device='cpu', **kw)
    in_order = list(batches)
    del batches[:]

    ended = []
    real_decode = pageload.decode_page

    def reverse(path, *a):
        time.sleep(0.08 * (5 - int(path[-8:-4])))
        image = real_decode(path, *a)
        ended.append(int(path[-8:-4]))
        return image

    monkeypatch.setattr(pageload, 'decode_page', reverse)
    port_recode.recode(out_pdf=str(tmp_path / 'b.pdf'), device='cpu', **kw)
    if port_workers.decode_width() > 1:
        assert ended != sorted(ended)
    assert sorted(ended) == list(range(5))
    # page 1 is RGB: three batches of one key each
    assert batches == in_order and len(batches) == 3
    assert (tmp_path / 'a.pdf').read_bytes() == \
        (tmp_path / 'b.pdf').read_bytes()


class _CountingPool:
    """A pool that runs each submit at once and counts the submits."""

    def __init__(self):
        self.submits = 0

    def submit(self, fn, *args):
        self.submits += 1
        fut = concurrent.futures.Future()
        fut.set_result(fn(*args))
        return fut

    def shutdown(self, **kw):
        pass


@pytest.mark.parametrize('cores', [3, 8])
@pytest.mark.parametrize('ext', ['jp2', 'png'])
def test_pages_in_flight_are_twice_the_width_of_their_pool(monkeypatch, ext,
                                                           cores):
    """A JPEG2000 stack keeps twice ``jp2_decode_width()`` pages in
    flight, any other stack twice ``decode_width()``; the pages come out
    in page order."""
    monkeypatch.setattr(port_workers, 'cores', lambda: cores)
    procs, threads = _CountingPool(), _CountingPool()
    monkeypatch.setattr(port_workers, 'WORKERS', procs)
    monkeypatch.setattr(port_workers, 'bound_threads',
                        lambda prefix, width: threads)
    monkeypatch.setattr(pageload, 'decode_page',
                        lambda path, *a: Image.new('L', (int(path[1:3]), 1)))
    pool, width = ((procs, port_workers.jp2_decode_width()) if ext == 'jp2'
                   else (threads, port_workers.decode_width()))
    n = 20
    pages = port_recode._pages_ahead(
        ['p%02d.%s' % (i, ext) for i in range(1, n + 1)], None, 'pillow',
        None, False, [])
    sent = []
    for page in pages:
        sent.append((page.size[0], pool.submits))
    assert (procs.submits + threads.submits, pool.submits) == (n, n)
    assert sent == [(k, min(n, 2 * width + k - 1)) for k in range(1, n + 1)]


@pytest.mark.parametrize('ext', ['png', 'jp2'])
def test_corrupt_page_raises_as_before(tmp_path, ext):
    kw = _book(tmp_path, [ext] * 4)
    bad = tmp_path / ('page_0002.' + ext)
    data = bad.read_bytes()
    bad.write_bytes(data[:len(data) // 2])
    with pytest.raises(Exception) as before:
        port_recode._load_page_image(None, [str(bad)], 0, None, 'pillow',
                                     None, False, None)
    with pytest.raises(Exception) as now:
        port_recode.recode(out_pdf=str(tmp_path / 'o.pdf'), device='cpu',
                           **kw)
    assert type(now.value) is type(before.value)
    assert str(now.value) == str(before.value)
    assert not _leftover_threads()


def _probe(path, impl):
    """A worker's timed decode of ``path``, then its modules."""
    return ("(__import__('%s', fromlist=['timed']).timed(__import__('%s',"
            " fromlist=['decode_packed']).decode_packed, %r, None, %r, None,"
            " False), sorted(__import__('sys').modules))"
            % (port_workers.__name__, pageload.__name__, path, impl))


def test_worker_process_holds_no_torch(tmp_path):
    """Each worker decodes a page, then lists its modules: twice the
    pool's width of probes, so that every worker starts."""
    path = _save(_pixels('L'), str(tmp_path / 'p.jp2'))
    futs = [port_workers.WORKERS.submit(eval, _probe(path, 'pillow'))
            for _ in range(2 * port_workers.jp2_decode_width())]
    for fut in futs:
        page, mods = fut.result(120)
        assert page.value[:2] == ('L', (W, H)) and page.pid != os.getpid()
        assert 'PIL' in mods and pageload.__name__ in mods
        assert port_workers.__name__ in mods
        assert 'torch' not in mods


def test_tpu_decode_worker_holds_no_torch(tmp_path):
    """Under ``-J tpu`` a worker's decode checks the coder
    (``jpeg2000.impl_available``), which imports ``codecs/jp2host.py``:
    that module, with its Tier-1 spans, must not bring torch into the
    worker."""
    path = _save(_pixels('RGB'), str(tmp_path / 'p.jp2'))
    host = pageload.__name__.replace('pipeline.pageload', 'codecs.jp2host')
    futs = [port_workers.WORKERS.submit(eval, _probe(path, 'tpu'))
            for _ in range(2 * port_workers.jp2_decode_width())]
    for fut in futs:
        page, mods = fut.result(120)
        assert page.value[:2] == ('RGB', (W, H)) and page.pid != os.getpid()
        assert host in mods
        assert 'torch' not in mods


def test_workers_start_anew_after_one_dies(tmp_path):
    """The work of a worker killed while it runs raises BrokenProcessPool
    (an idle worker's death may be seen before the next submit, which
    then starts the new pool at once); the next decode starts anew."""
    path = _save(_pixels('L'), str(tmp_path / 'p.jp2'))
    args = (pageload.decode_packed, path, None, 'pillow', None, False)
    port_workers.WORKERS.submit(*args).result(120)
    pidfile = tmp_path / 'pid'
    fut = port_workers.WORKERS.submit(
        eval, "open(%r, 'w').write(str(__import__('os').getpid()))"
              " and __import__('time').sleep(120)" % str(pidfile))
    deadline = time.time() + 60
    while not (pidfile.exists() and pidfile.read_text().isdigit()):
        assert time.time() < deadline and not fut.done()
        time.sleep(0.01)
    os.kill(int(pidfile.read_text()), signal.SIGKILL)
    with pytest.raises(BrokenProcessPool):
        fut.result(120)
    mode, size, data = port_workers.WORKERS.submit(*args).result(120)[:3]
    assert (mode, size, len(data)) == ('L', (W, H), W * H)


@pytest.mark.parametrize('impl,exts', [
    ('pillow', ['jp2', 'jp2', 'jp2']),
    ('tpu', ['jp2', 'png', 'jp2', 'png', 'jp2'])])
def test_jp2_book_byte_identical_with_jax(tmp_path, monkeypatch, impl, exts):
    """JPEG2000 pages (with PNG pages between them under -J tpu, each
    routed by its own file) recode to the JAX package's bytes."""
    from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    kw = dict(_book(tmp_path, exts), jpeg2000_implementation=impl)
    ours, ref = tmp_path / 'torch.pdf', tmp_path / 'jax.pdf'
    port_recode.recode(out_pdf=str(ours), device='cpu', **kw)
    jax_recode(out_pdf=str(ref), **kw)
    assert ours.read_bytes() == ref.read_bytes()


def test_traced_jp2_book_stores_the_workers_decodes(tmp_path):
    """Under a profiler session each worker decode is a record on a
    ``decode-proc-<pid>`` thread inside the call's root span, and the
    loader's waits are ``page_fetch`` spans; one ``image_load`` key a
    page."""
    kw = _book(tmp_path, ['jp2'] * 4, words=False)
    keys = []
    mp = pytest.MonkeyPatch()
    mp.setattr(port_recode, 'get_timing_summary',
               lambda t: keys.extend(k for k, _ in t) or {})
    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            port_recode.recode(out_pdf=str(tmp_path / 'o.pdf'),
                               device='cpu', verbose=True, **kw)
        recs = spans.collected()
    finally:
        spans.clear()
        mp.undo()
    root, = [r for r in recs if r.name == 'recode']
    loads = [r for r in recs if r.name == 'image_load']
    assert len(loads) == 4 and keys.count('image_load') == 4
    for r in loads:
        assert r.thread == 'decode-proc-%d' % r.thread_id
        assert r.call == root.call
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
        assert 0 <= r.cpu_ns <= r.end_ns - r.start_ns
    fetches = [r for r in recs if r.name == 'page_fetch']
    assert len(fetches) == 4 and {r.thread for r in fetches} == {'loader'}
