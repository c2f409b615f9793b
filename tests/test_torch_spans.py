"""The port's span helper (``utils/spans.py``) and the spans of its
``recode()``: nesting, the call id across the loader, the decode
threads and the encode pool, nothing recorded while tracing is off,
every thread's spans in a ``--profile`` trace, and the timing keys
unchanged."""

import collections
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from archive_pdf_tools_tpu.pipeline import recode as jax_recode_mod
from archive_pdf_tools_tpu_torch.pipeline import recode as port_recode
from archive_pdf_tools_tpu_torch.utils import spans
from archive_pdf_tools_tpu_torch.utils import workers as port_workers
from archive_pdf_tools_tpu_torch.utils.spans import span
from tests.fixtures import HOCR_TEMPLATE, render_book_page, words_to_hocr_page

MAIN_SPANS = ('recode', 'batch_wait', 'process_batch', 'encode_wait',
              'pdf_write')
ENCODE_SPANS = ('mask_jbig2', 'fg_jp2', 'bg_jp2')


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _book(tmp_path, n_pages=4):
    hocr = []
    for i in range(n_pages):
        img, wds = render_book_page(320, 416, seed=i, noise=0)
        Image.fromarray(img).save(str(tmp_path / ('page_%04d.png' % i)))
        hocr.append(words_to_hocr_page(wds, 320, 416, page_no=i, dpi=100))
    path = tmp_path / 'book.hocr'
    path.write_text(HOCR_TEMPLATE % '\n'.join(hocr), encoding='utf-8')
    return dict(from_imagestack=str(tmp_path / 'page_*.png'),
                hocr_file=str(path), dpi=100, jbig2=True, bg_downsample=3,
                verbose=True)


def _keys(monkeypatch, module):
    """The timing keys a recode reports, caught at its summary."""
    keys = []
    monkeypatch.setattr(module, 'get_timing_summary',
                        lambda t: keys.extend(k for k, _ in t) or {})
    return keys


def _wall(r):
    return r.end_ns - r.start_ns


def test_tracing_check_is_process_wide():
    """The check reads True on a thread the session did not start on,
    where torch's per-thread flag reads False."""
    seen = {}

    def probe():
        seen['spans'] = spans.tracing()
        seen['per_thread'] = torch._C._autograd._profiler_enabled()

    assert not spans.tracing()
    with _cpu_profile():
        t = threading.Thread(target=probe)
        t.start()
        t.join(30)
    assert not t.is_alive()
    assert seen == {'spans': True, 'per_thread': False}
    assert not spans.tracing()


def test_nesting_and_parents_on_one_thread():
    sink = []
    with _cpu_profile():
        with spans.call('recode') as root:
            with span('outer', sink):
                with span('inner', sink):
                    pass
                with span('second'):
                    pass
    recs = {r.name: r for r in spans.collected()}
    assert [k for k, _ in sink] == ['inner', 'outer']
    assert recs['recode'].parent is None
    assert recs['outer'].parent == recs['recode'].id
    assert recs['inner'].parent == recs['outer'].id
    assert recs['second'].parent == recs['outer'].id
    assert {r.call for r in recs.values()} == {root.call_id}
    assert {r.thread_id for r in recs.values()} == {threading.get_ident()}
    for r in recs.values():
        assert 0 <= r.cpu_ns <= _wall(r)
    assert spans.current_call() is None


def test_call_id_reaches_the_threads_it_starts():
    """A call's loader thread and pool threads carry its id, read on the
    starting thread; a second call on another thread at the same time
    keeps its own."""
    barrier = threading.Barrier(2, timeout=30)

    def one_call(tag):
        with spans.call('recode'):
            cid = spans.current_call()

            def loader():
                spans.bind(cid)
                with span('image_load'):
                    barrier.wait()

            t = threading.Thread(target=loader, name='loader-' + tag)
            t.start()
            def encode():
                with span('fg_jp2'):
                    pass

            with ThreadPoolExecutor(2, initializer=spans.bind,
                                    initargs=(cid,)) as pool:
                pool.submit(encode).result(30)
            t.join(30)
            assert not t.is_alive()

    with _cpu_profile():
        other = threading.Thread(target=one_call, args=('b',))
        other.start()
        one_call('a')
        other.join(30)
    assert not other.is_alive()
    recs = spans.collected()
    roots = [r for r in recs if r.name == 'recode']
    assert len(roots) == 2 and roots[0].call != roots[1].call
    for root in roots:
        mine = [r for r in recs if r.call == root.call]
        assert sorted(r.name for r in mine) == ['fg_jp2', 'image_load',
                                                'recode']
        # idents may be reused once a thread ends; names are not
        threads = {r.name: r.thread for r in mine}
        assert len(set(threads.values())) == 3
        assert threads['image_load'].startswith('loader-')
        assert all(r.parent is None for r in mine)


def test_store_is_capped(monkeypatch):
    monkeypatch.setattr(spans, 'CAP', 3)
    with _cpu_profile():
        for _ in range(5):
            with span('x'):
                pass
    assert len(spans.collected()) == 3
    assert spans.dropped() == 2
    spans.clear()
    assert spans.collected() == [] and spans.dropped() == 0


def _raise(*a, **k):
    raise AssertionError('record_function entered while tracing is off')


def test_off_records_nothing(tmp_path, monkeypatch):
    """Without a profiler session a recode enters no record_function and
    stores nothing; its timing keys still reach the sink."""
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', _raise)
    keys = _keys(monkeypatch, port_recode)
    port_recode.recode(out_pdf=str(tmp_path / 'o.pdf'), device='cpu',
                       **_book(tmp_path, n_pages=2))
    assert spans.collected() == [] and spans.dropped() == 0
    assert {'image_load', 'batch_wait', 'threshold', 'mask_jbig2',
            'fg_jp2', 'bg_jp2', 'page_image_insertion'} <= set(keys)


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """One small worded book recoded under a CPU profiler session: the
    exported trace's events, the store, the keys, the PDF's bytes."""
    tmp = tmp_path_factory.mktemp('traced')
    kw = _book(tmp)
    mp = pytest.MonkeyPatch()
    mp.setenv('SOURCE_DATE_EPOCH', '1700000000')
    try:
        keys = _keys(mp, port_recode)
        port_recode.recode(out_pdf=str(tmp / 'off.pdf'), device='cpu', **kw)
        off_keys = list(keys)
        del keys[:]
        spans.clear()
        with _cpu_profile() as prof:
            port_recode.recode(out_pdf=str(tmp / 'on.pdf'), device='cpu',
                               **kw)
        recs = spans.collected()
        spans.clear()
        prof.export_chrome_trace(str(tmp / 'trace.json'))
        with open(tmp / 'trace.json') as fp:
            events = json.load(fp)['traceEvents']
        jax_keys = _keys(mp, jax_recode_mod)
        jax_recode_mod.recode(out_pdf=str(tmp / 'jax.pdf'), **kw)
    finally:
        mp.undo()
    return dict(recs=recs, events=events, keys=list(keys),
                off_keys=off_keys, jax_keys=list(jax_keys),
                same_bytes=(tmp / 'off.pdf').read_bytes()
                == (tmp / 'on.pdf').read_bytes())


def test_traced_recode_puts_main_thread_spans_in_the_trace(traced):
    ann = [e for e in traced['events'] if e.get('cat') == 'user_annotation']
    root_tid = {e['tid'] for e in ann if e['name'] == 'recode'}
    assert len(root_tid) == 1
    names = {e['name'] for e in ann if e['tid'] in root_tid}
    assert set(MAIN_SPANS) <= names
    assert traced['same_bytes']


def test_store_holds_every_threads_spans(traced):
    recs = traced['recs']
    root, = [r for r in recs if r.name == 'recode']
    assert all(r.call == root.call for r in recs)
    by_name = collections.defaultdict(set)
    for r in recs:
        by_name[r.name].add(r.thread)
        assert 0 <= r.cpu_ns <= _wall(r)
    # the page decodes run ahead of the loader, on decode threads; the
    # loader waits for each page in order
    assert by_name['image_load'] and all(t.startswith('decode_')
                                         for t in by_name['image_load'])
    assert by_name['page_fetch'] == {'loader'}
    for name in ENCODE_SPANS:
        assert by_name[name] and all(t.startswith('encode')
                                     for t in by_name[name])
    for name in MAIN_SPANS:
        assert by_name[name] == {root.thread}


def test_recode_children_cover_its_wall_time(traced):
    recs = traced['recs']
    root, = [r for r in recs if r.name == 'recode']
    kids = [r for r in recs if r.parent == root.id]
    assert {r.name for r in kids} == {
        'text_pages', 'hocr_jobs', 'batch_wait', 'process_batch',
        'encode_wait', 'page_image_insertion', 'pdf_write'}
    assert all(r.thread_id == root.thread_id for r in kids)
    assert sum(map(_wall, kids)) >= 0.95 * _wall(root)
    stages = {r.name for r in recs
              if r.parent in {k.id for k in kids
                              if k.name == 'process_batch'}}
    assert {'hocr_mask_gen', 'threshold', 'fast_denoise', 'fg_partial_blur',
            'bg_partial_blur', 'bg_downsample', 'mask_fetch'} <= stages


def test_timing_keys_unchanged(traced):
    """The keys a recode reports, traced or not, are those it reported
    before spans (4 pages in 2 batches of 2), which are the JAX package's
    less its own ``est_*`` keys, and each thread's keys come in that
    thread's order."""
    per_page = ('image_load', 'mask_jbig2', 'fg_jp2', 'bg_jp2',
                'page_image_insertion')
    per_batch = ('hocr_mask_gen', 'threshold', 'fast_denoise',
                 'fg_partial_blur', 'bg_partial_blur', 'bg_downsample',
                 'mask_fetch')
    want = collections.Counter(dict([(k, 4) for k in per_page]
                                    + [(k, 2) for k in per_batch]
                                    + [('batch_wait', 3)]))
    jax = collections.Counter(k for k in traced['jax_keys']
                              if not k.startswith('est_'))
    assert jax == want
    assert collections.Counter(traced['keys']) == want
    assert collections.Counter(traced['off_keys']) == want
    keyed = set(want)
    by_thread = collections.defaultdict(list)
    for r in sorted(traced['recs'], key=lambda r: r.end_ns):
        if r.name in keyed:
            by_thread[r.thread_id].append(r.name)
    for names in by_thread.values():
        it = iter(traced['keys'])
        assert all(n in it for n in names)   # a subsequence of the sink


def test_tier1_band_spans_on_an_rgb_jtpu_page(tmp_path, monkeypatch):
    """Under a profiler session an RGB ``-J tpu`` page stores a
    ``t1_band`` record for each band's Tier-1 call, on the band threads
    (the encode thread where the coder runs its bands in turn), bound to
    the recode call, and ``t1_rescue`` only inside a layer's encode; the
    bytes equal an untraced run's."""
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    img, wds = render_book_page(320, 416, seed=3, noise=8, rgb=True)
    Image.fromarray(img).save(str(tmp_path / 'page_0000.png'))
    hocr = tmp_path / 'book.hocr'
    hocr.write_text(HOCR_TEMPLATE % words_to_hocr_page(wds, 320, 416,
                                                       dpi=100),
                    encoding='utf-8')
    kw = dict(from_imagestack=str(tmp_path / 'page_*.png'),
              hocr_file=str(hocr), dpi=100, jbig2=True, bg_downsample=3,
              jpeg2000_implementation='tpu', device='cpu')
    port_recode.recode(out_pdf=str(tmp_path / 'off.pdf'), **kw)
    assert spans.collected() == []
    with _cpu_profile():
        port_recode.recode(out_pdf=str(tmp_path / 'on.pdf'), **kw)
    recs = spans.collected()
    root, = [r for r in recs if r.name == 'recode']
    bands = [r for r in recs if r.name == 't1_band']
    # three components of the fg (416x320, 5 levels) and of the bg
    # (139x107, 4 levels): 3 * (16 + 13) band calls
    assert len(bands) == 87
    assert all(r.call == root.call and 0 <= r.cpu_ns <= _wall(r)
               for r in bands)
    band_pool = port_workers.tier1_width() > 1
    assert all(r.thread.startswith('t1_band' if band_pool else 'encode')
               for r in bands)
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == 't1_rescue':
            assert by_id[r.parent].name in ('fg_jp2', 'bg_jp2')
    assert (tmp_path / 'off.pdf').read_bytes() == \
        (tmp_path / 'on.pdf').read_bytes()


def test_profile_dir_trace_holds_every_thread(tmp_path):
    out = tmp_path / 'prof'
    port_recode.recode(out_pdf=str(tmp_path / 'o.pdf'), device='cpu',
                       profile_dir=str(out), **_book(tmp_path, n_pages=2))
    with open(out / 'trace.json') as fp:
        events = json.load(fp)['traceEvents']
    tids = collections.defaultdict(set)
    for e in events:
        if e.get('cat') == 'user_annotation':
            tids[e['name']].add(e['tid'])
    main = tids['batch_wait']
    assert len(main) == 1
    assert tids['image_load'] and not tids['image_load'] & main
    # the loader's waits for the decode threads, on its own thread
    assert len(tids['page_fetch']) == 1
    assert not tids['page_fetch'] & (main | tids['image_load'])
    for name in ENCODE_SPANS:
        assert tids[name] and not tids[name] & main
        assert not tids[name] & (tids['image_load'] | tids['page_fetch'])


def _tv_batch():
    """Two small worded pages and their hOCR word data, as
    ``decompose_masks`` takes them."""
    import io
    imgs, pages = [], []
    for i in range(2):
        img, words = render_book_page(48, 64, n_lines=3, seed=i, noise=8)
        imgs.append(img)
        pages.append(words_to_hocr_page(words, 48, 64, page_no=i, dpi=100))
    doc = io.BytesIO((HOCR_TEMPLATE % '\n'.join(pages)).encode())
    return imgs, [port_recode.hocr_page_to_word_data(p)
                  for p in port_recode.hocr_page_iterator(doc)]


def test_tv_spans(monkeypatch):
    """Under a profiler session a ``--denoise-mask bregman`` batch stores
    one ``tv_denoise`` record, inside the ``denoise`` stage, and one
    ``tv_sync`` record inside it for each host read of the device that
    the TV makes (one a call of ``_fma``, three an iteration); without a
    session it stores nothing, and the mask is the same."""
    from archive_pdf_tools_tpu_torch.mrc.api import decompose_masks
    from archive_pdf_tools_tpu_torch.ops import tv
    imgs, wds = _tv_batch()
    reads = []
    real = tv._fma

    def counted(*args, **kw):
        reads.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(tv, '_fma', counted)
    off, _ = decompose_masks(imgs, wds, dpi=100, denoise_mask='bregman',
                             device='cpu')
    assert spans.collected() == [] and len(reads) == 300
    del reads[:]
    with _cpu_profile():
        on, _ = decompose_masks(imgs, wds, dpi=100, denoise_mask='bregman',
                                device='cpu')
    recs = spans.collected()
    by_id = {r.id: r for r in recs}
    tvs = [r for r in recs if r.name == 'tv_denoise']
    syncs = [r for r in recs if r.name == 'tv_sync']
    assert len(tvs) == 1 and by_id[tvs[0].parent].name == 'denoise'
    assert len(syncs) == len(reads) == 300
    assert all(r.parent == tvs[0].id for r in syncs)
    assert all(tvs[0].start_ns <= r.start_ns <= r.end_ns <= tvs[0].end_ns
               for r in syncs)
    assert torch.equal(on, off)


def test_tv_read_keeps_the_fma():
    """``_fma`` gives the same float32 bits with the TV's timed read as
    with the plain one that B7's CPU path keeps."""
    from archive_pdf_tools_tpu_torch.ops import dwt97, tv
    g = torch.Generator().manual_seed(11)
    a, b, c = (torch.randn(4096, generator=g) for _ in range(3))
    with _cpu_profile():
        timed = dwt97._fma(a, b, c, tv._read)
    assert torch.equal(timed.view(torch.int32),
                       dwt97._fma(a, b, c).view(torch.int32))
    assert [r.name for r in spans.collected()] == ['tv_sync']
