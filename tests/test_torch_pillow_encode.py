"""Pillow's JPEG2000 layer encode in worker processes
(``codecs/pillow_jp2.py``, ``utils/workers.py`` ``ENCODERS``): a
``-J pillow`` layer that ``recode`` encodes in a worker has the bytes of
the in-process encode, a book the JAX package's bytes on every run, a
traced book one ``jp2_pillow`` record a layer, a failing layer the old
exception, a killed worker a new pool, the other callers and ``-J tpu``
no worker, and a worker no torch."""

import io
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
from archive_pdf_tools_tpu.pipeline.recode import recode as jax_recode
from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import \
    main as comp_main
from archive_pdf_tools_tpu_torch.codecs import pillow_jp2
from archive_pdf_tools_tpu_torch.codecs.jpeg2000 import _pillow_kwargs
from archive_pdf_tools_tpu_torch.codecs.mrc_encode import encode_mrc_img
from archive_pdf_tools_tpu_torch.pdf import builder as port_builder
from archive_pdf_tools_tpu_torch.pipeline import recode as port_recode
from archive_pdf_tools_tpu_torch.utils import spans
from archive_pdf_tools_tpu_torch.utils import workers as port_workers
from tests.fixtures import HOCR_TEMPLATE, render_book_page, words_to_hocr_page
from tests.test_torch_cli_tools import _jpeg_source

torch.set_num_threads(2)

W, H = 240, 312


def _rates(rate):
    return 'quality_mode:"rates";quality_layers:[%d]' % rate


def _layer(mode, imgtype, seed=0):
    img, _ = render_book_page(W, H, seed=seed, noise=8, rgb=mode == 'RGB')
    if imgtype == 'bg':       # a bg layer is the page cut to a third
        img = np.asarray(Image.fromarray(img).resize((W // 3, H // 3)))
    return img


def _book(tmp_path, exts):
    """A worded page per extension (page 1 RGB), with hOCR."""
    hocr = []
    for i, ext in enumerate(exts):
        img, wds = render_book_page(W, H, seed=i, noise=0, rgb=i == 1)
        im = Image.fromarray(img)
        path = str(tmp_path / ('page_%04d.%s' % (i, ext)))
        if ext == 'jp2':
            im.save(path, irreversible=True, quality_mode='rates',
                    quality_layers=[10])
        else:
            im.save(path)
        hocr.append(words_to_hocr_page(wds, W, H, page_no=i, dpi=100))
    path = tmp_path / 'book.hocr'
    path.write_text(HOCR_TEMPLATE % '\n'.join(hocr), encoding='utf-8')
    return dict(from_imagestack=str(tmp_path / 'page_*'), hocr_file=str(path),
                dpi=100, jbig2=True)


def _fresh_encoders(monkeypatch):
    """An encode pool of this test's own, in the place recode reads."""
    workers = port_workers.Workers(port_workers.encode_width)
    monkeypatch.setattr(port_workers, 'ENCODERS', workers)
    return workers


@pytest.mark.parametrize('mode', ['L', 'RGB'])
@pytest.mark.parametrize('imgtype,rate', [('fg', 750), ('bg', 500),
                                          ('fg', 300), ('bg', 100)])
def test_worker_bytes_equal_in_process_encode(mode, imgtype, rate):
    """pillow_ds3's rates and its HQ rates, grey and RGB fg and bg."""
    layer = _layer(mode, imgtype)
    flags = [_rates(rate)]
    here = encode_mrc_img(layer, flags, imgtype=imgtype,
                          jpeg2000_implementation='pillow')
    there = encode_mrc_img(layer, flags, imgtype=imgtype,
                           jpeg2000_implementation='pillow',
                           encoders=port_workers.ENCODERS)
    buf = io.BytesIO()
    Image.fromarray(layer).save(buf, format='JPEG2000',
                                **_pillow_kwargs(flags[0]))
    assert there == here
    assert here.data == buf.getvalue()
    assert (here.width, here.height, here.gray) == \
        (layer.shape[1], layer.shape[0], mode == 'L')


@pytest.mark.parametrize('ext', ['png', 'jp2'])
def test_pillow_book_byte_identical_with_jax_on_every_run(tmp_path,
                                                          monkeypatch, ext):
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    monkeypatch.setattr(port_builder, 'PRODUCER', JAX_PRODUCER)
    kw = dict(_book(tmp_path, [ext] * 3), jpeg2000_implementation='pillow')
    ours = [tmp_path / 'torch_a.pdf', tmp_path / 'torch_b.pdf']
    for out in ours:
        port_recode.recode(out_pdf=str(out), device='cpu', **kw)
    ref = tmp_path / 'jax.pdf'
    jax_recode(out_pdf=str(ref), **kw)
    assert ours[0].read_bytes() == ours[1].read_bytes() == ref.read_bytes()


def test_traced_book_stores_one_record_a_layer(tmp_path):
    kw = _book(tmp_path, ['png'] * 3)
    spans.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            port_recode.recode(out_pdf=str(tmp_path / 'o.pdf'),
                               device='cpu', **kw)
        recs = spans.collected()
    finally:
        spans.clear()
    root, = [r for r in recs if r.name == 'recode']
    layers = [r for r in recs if r.name in ('fg_jp2', 'bg_jp2')]
    encodes = [r for r in recs if r.name == 'jp2_pillow']
    assert len(layers) == 6 and len(encodes) == len(layers)
    for r in encodes:
        assert r.thread == 'encode-proc-%d' % r.thread_id
        assert r.thread_id != os.getpid() and r.parent is None
        assert r.call == root.call
        assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
        assert 0 <= r.cpu_ns <= r.end_ns - r.start_ns
    # each encode lies inside the wait of the pool thread that sent it
    for r in encodes:
        assert any(s.start_ns <= r.start_ns and r.end_ns <= s.end_ns
                   for s in layers)


def test_failing_layer_raises_as_before():
    layer = _layer('L', 'fg')
    for flags in ('quality_mode:"rates";quality_layers:["x"]',
                  'quality_mode:"rates";quality_layers:[750];'
                  'num_resolutions:40'):
        with pytest.raises(Exception) as before:
            Image.fromarray(layer).save(io.BytesIO(), format='JPEG2000',
                                        **_pillow_kwargs(flags))
        with pytest.raises(Exception) as now:
            encode_mrc_img(layer, [flags], imgtype='fg',
                           jpeg2000_implementation='pillow',
                           encoders=port_workers.ENCODERS)
        assert type(now.value) is type(before.value)
        assert str(now.value) == str(before.value)


def test_failing_layer_in_a_book_raises_as_before(tmp_path):
    kw = _book(tmp_path, ['png'] * 3)
    flags = 'quality_mode:"rates";quality_layers:[750];num_resolutions:40'
    with pytest.raises(Exception) as before:
        Image.fromarray(_layer('L', 'fg')).save(
            io.BytesIO(), format='JPEG2000', **_pillow_kwargs(flags))
    with pytest.raises(Exception) as now:
        port_recode.recode(out_pdf=str(tmp_path / 'o.pdf'), device='cpu',
                           fg_compression_flags=[flags], **kw)
    assert type(now.value) is type(before.value)
    assert str(now.value) == str(before.value)
    assert not [t.name for t in threading.enumerate()
                if t.name == 'loader' or t.name.startswith('encode')]


def _kill_busy_worker(workers, tmp_path):
    """SIGKILL the worker that runs a task which writes its pid and
    sleeps; returns that task's future."""
    pidfile = tmp_path / 'pid'
    fut = workers.submit(eval, "open(%r, 'w').write(str(__import__('os')"
                               ".getpid())) and __import__('time').sleep(120)"
                         % str(pidfile))
    deadline = time.time() + 60
    while not (pidfile.exists() and pidfile.read_text().isdigit()):
        assert time.time() < deadline and not fut.done()
        time.sleep(0.01)
    os.kill(int(pidfile.read_text()), signal.SIGKILL)
    return fut


def test_encoders_start_anew_after_one_dies(tmp_path):
    """The work of a worker that dies raises BrokenProcessPool; the next
    layer starts a new pool and gets the in-process bytes."""
    layer = _layer('L', 'bg')
    flags = [_rates(500)]
    encode_mrc_img(layer, flags, imgtype='bg',
                   jpeg2000_implementation='pillow',
                   encoders=port_workers.ENCODERS)
    with pytest.raises(BrokenProcessPool):
        _kill_busy_worker(port_workers.ENCODERS, tmp_path).result(120)
    now = encode_mrc_img(layer, flags, imgtype='bg',
                         jpeg2000_implementation='pillow',
                         encoders=port_workers.ENCODERS)
    assert now == encode_mrc_img(layer, flags, imgtype='bg',
                                 jpeg2000_implementation='pillow')


def test_tpu_recode_starts_no_encode_worker(tmp_path, monkeypatch):
    workers = _fresh_encoders(monkeypatch)
    port_recode.recode(out_pdf=str(tmp_path / 'tpu.pdf'), device='cpu',
                       jpeg2000_implementation='tpu',
                       **_book(tmp_path, ['png'] * 2))
    assert workers._pool is None
    port_recode.recode(out_pdf=str(tmp_path / 'pillow.pdf'), device='cpu',
                       **_book(tmp_path, ['png'] * 2))
    assert workers._pool is not None
    workers.shutdown()


def test_compress_pdf_images_starts_no_encode_worker(tmp_path, monkeypatch):
    workers = _fresh_encoders(monkeypatch)
    src, hocr = _jpeg_source(tmp_path, noise=False)
    out = str(tmp_path / 'out.pdf')
    assert comp_main([src, hocr, out, '--dpi', '100', '--device', 'cpu']) \
        == 0
    assert os.path.getsize(out) > 0
    assert workers._pool is None


def test_encode_worker_holds_no_torch():
    """Each worker encodes a layer, then lists its modules."""
    probe = ("(__import__('%s', fromlist=['timed']).timed(__import__('%s',"
             " fromlist=['encode']).encode,"
             " __import__('numpy').full((64, 48), 128, 'uint8'), %r),"
             " sorted(__import__('sys').modules))"
             % (port_workers.__name__, pillow_jp2.__name__, _rates(750)))
    futs = [port_workers.ENCODERS.submit(eval, probe)
            for _ in range(2 * port_workers.encode_width())]
    for fut in futs:
        out, mods = fut.result(120)
        assert out.value == pillow_jp2.encode(
            np.full((64, 48), 128, 'uint8'), _rates(750))
        assert out.pid != os.getpid()
        assert 'PIL' in mods and pillow_jp2.__name__ in mods
        assert port_workers.__name__ in mods
        assert 'torch' not in mods
