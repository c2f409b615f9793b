"""Page shards on the port (``parallel/``), held against the JAX
package's ``parallel/`` and against the one-device port.

Shards run on the CPU here: a device list may name one device several
times (``['cpu'] * 4``), which runs the shards in turn through the same
code as separate cards.  Every kernel works page by page, so a split
must give the one-device bytes, provided the blur's radius bucket comes
from the whole batch: the batches below hold pages whose noise needs
different buckets.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from archive_pdf_tools_tpu.parallel import multihost as JM
from archive_pdf_tools_tpu.parallel.sharded import \
    split_lines_per_shard as jax_split

from archive_pdf_tools_tpu_torch.mrc import api as TA
from archive_pdf_tools_tpu_torch.mrc import decompose as TD
from archive_pdf_tools_tpu_torch.mrc.hocr_prep import prepare_lines
from archive_pdf_tools_tpu_torch.mrc.step import mrc_full_step
from archive_pdf_tools_tpu_torch.ops.sigma import estimate_noise
from archive_pdf_tools_tpu_torch.parallel import mesh, multihost, sharded
from archive_pdf_tools_tpu_torch.pipeline import recode as TR
from archive_pdf_tools_tpu_torch.pipeline.recode import recode

from tests.fixtures import make_book
from tests.scanfix import synth_scan

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DPI = 150


def _pages(rgb=False, noises=(0.0, 30.0, 9.0, 0.0)):
    """Four scans with lines; their noise needs radius buckets 4, 16, 4
    and 4."""
    scans = [synth_scan(h=224, w=256, seed=20 + i, dpi=DPI, noise_sigma=n)
             for i, n in enumerate(noises)]
    pages = [p for p, _ in scans]
    if rgb:
        pages = [np.stack([p, np.clip(p.astype(int) + 5, 0, 255),
                           np.clip(p.astype(int) - 5, 0, 255)], -1)
                 .astype(np.uint8) for p in pages]
    return pages, [wd for _, wd in scans]


def _buckets(pages, k):
    """The radius bucket of the whole batch and of each of k shards."""
    gray = torch.from_numpy(np.stack(pages))
    if gray.dim() == 4:
        gray = TD.gray_601(gray)
    sig = estimate_noise(gray)
    per = len(pages) // k
    return (TD.pick_blur_radius(sig),
            [TD.pick_blur_radius(sig[s * per:(s + 1) * per])
             for s in range(k)])


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('n_shards', [2, 4])
def test_split_lines_per_shard_matches_jax(seed, n_shards):
    rng = np.random.default_rng(seed)
    n, batch = 40, 8
    boxes = rng.integers(0, 100, (4, n)).astype(np.int32)
    pages = rng.integers(0, batch, n).astype(np.int32)
    sel = rng.integers(0, 3, n).astype(np.int32)
    got = sharded.split_lines_per_shard(boxes, pages, sel, batch, n_shards)
    ref = jax_split(boxes, pages, sel, batch, n_shards)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and (g == r).all()


def _spy_taps(monkeypatch):
    """The tap count of every blur_sauvola call of the shards."""
    seen = []
    real = sharded.blur_sauvola

    def spy(gray, taps, window):
        seen.append(taps.shape[1])
        return real(gray, taps, window)

    monkeypatch.setattr(sharded, 'blur_sauvola', spy)
    return seen


@pytest.mark.parametrize('k,rgb,denoise', [(2, False, 'fast'),
                                           (4, True, 'none')])
def test_sharded_step_equals_one_device_step(k, rgb, denoise, monkeypatch):
    pages, wds = _pages(rgb)
    whole, shards = _buckets(pages, k)
    assert whole == 16 and len(set(shards)) > 1
    taps = _spy_taps(monkeypatch)
    b, h, w = len(pages), 224, 256
    page_boxes = [prepare_lines(wd, w, h) for wd in wds]
    boxes = np.zeros((4, 64), np.int32)
    boxes[1, 0] = boxes[3, 0] = 1
    pg = np.zeros(64, np.int32)
    i = 0
    for p, bx in enumerate(page_boxes):
        for box in bx:
            i += 1
            boxes[:, i] = box
            pg[i] = p
    assert i > 8
    sel = np.zeros(64, np.int32)
    sel[1:i + 1] = np.arange(i) % 3
    window = 31
    imgs = torch.from_numpy(np.stack(pages))
    ref = mrc_full_step(imgs, boxes, pg, sel, window, rgb=rgb,
                        denoise=denoise)
    sb, sp, ss = sharded.split_lines_per_shard(boxes, pg, sel, b, k)
    step = sharded.sharded_mrc_step(mesh.page_devices(devices=['cpu'] * k),
                                    window, rgb=rgb, denoise=denoise)
    got = step(imgs, sb, sp, ss)
    for g, r in zip(got, ref[:3]):
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.equal(g, r)
    # every shard blurs in the whole batch's bucket, not its own
    assert taps == [2 * whole + 1] * (1 + k)


@pytest.mark.parametrize('k', [2, 4])
def test_decompose_over_devices_equals_one_device(k, monkeypatch):
    pages, wds = _pages(rgb=k == 4)
    seen = []
    real = sharded.sharded_line_thresholds

    def spy(grays, lines, window):
        seen.append(len(grays))
        return real(grays, lines, window)

    monkeypatch.setattr(TA, 'sharded_line_thresholds', spy)
    taps = _spy_taps(monkeypatch)
    sink1, sinkk = [], []
    m1, d1 = TA.decompose_masks(pages, wds, dpi=DPI, device='cpu',
                                timing_data=sink1)
    f1, b1 = TA.decompose_layers(m1, d1)
    mk, dk = TA.decompose_masks(pages, wds, dpi=DPI, device='cpu',
                                devices=['cpu'] * k, timing_data=sinkk)
    fk, bk = TA.decompose_layers(mk, dk, devices=['cpu'] * k)
    assert seen == [1, k]
    assert taps == [2 * _buckets(pages, k)[0] + 1] * (1 + k)
    assert torch.equal(m1, mk)
    assert (f1 == fk).all() and (b1 == bk).all()
    assert [key for key, _ in sink1] == [key for key, _ in sinkk]


def test_devices_fall_back_to_one_device():
    assert mesh.split_devices(['cpu'] * 4, 6) is None
    assert mesh.split_devices(['cpu'] * 4, 3) is None
    assert mesh.split_devices(None, 8) is None
    assert mesh.split_devices(['cpu'] * 4, 8) == [torch.device('cpu')] * 4
    assert mesh.default_devices('cpu') == [torch.device('cpu')]
    assert mesh.page_devices(2, ['cpu'] * 3) == [torch.device('cpu')] * 2
    x = torch.arange(12).reshape(6, 2)
    parts = mesh.shard_pages([torch.device('cpu')] * 3, x)
    assert [p.shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(mesh.gather_pages(parts, 'cpu'), x)
    assert all(torch.equal(r, x) for r in mesh.replicate(['cpu'] * 2, x))
    with pytest.raises(ValueError, match='do not split'):
        mesh.shard_pages([torch.device('cpu')] * 4, x)


def test_default_devices_shard_only_when_no_device_is_named(monkeypatch):
    """Several visible cards: a pipeline with no device named shards over
    all of them (the JAX package's rule); a named device runs alone."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 4)
    assert mesh.default_devices() == [torch.device('cuda', i)
                                      for i in range(4)]
    assert mesh.default_devices('cuda:1') == [torch.device('cuda:1')]
    assert mesh.default_devices('cuda:0') == [torch.device('cuda:0')]
    assert mesh.default_devices('cpu') == [torch.device('cpu')]
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert mesh.default_devices() == [torch.device('cuda:0')]
    from archive_pdf_tools_tpu_torch.cli.recode_pdf import _parser
    args = _parser().parse_args(['--from-imagestack', 'x', '--out-pdf',
                                      'y.pdf'])
    assert args.device is None


@pytest.mark.parametrize('n_pages,n_hosts', [(1, 1), (7, 2), (8, 3),
                                             (9, 8), (100, 3)])
def test_page_ranges_match_jax(n_pages, n_hosts):
    for hid in range(n_hosts):
        assert multihost.assign_page_range(n_pages, n_hosts, hid) == \
            JM.assign_page_range(n_pages, n_hosts, hid)
        assert multihost.host_stop_after(n_pages, n_hosts, hid) == \
            JM.host_stop_after(n_pages, n_hosts, hid)
    with pytest.raises(ValueError):
        multihost.assign_page_range(n_pages, n_hosts, n_hosts)


def test_gather_artifacts_matches_jax(tmp_path):
    d0, d1 = tmp_path / 'h0', tmp_path / 'h1'
    d0.mkdir()
    d1.mkdir()
    (d0 / '000000_mask.jbig2').write_bytes(b'a')
    (d0 / '000001_meta.json').write_bytes(b'b')
    (d0 / 'notes.txt').write_bytes(b'x')
    (d1 / '000000_mask.jbig2').write_bytes(b'c')
    dirs = [str(d0), (str(d1), 2), str(tmp_path / 'missing')]
    n = multihost.gather_artifacts(dirs, str(tmp_path / 'port'))
    assert n == JM.gather_artifacts(dirs, str(tmp_path / 'jax')) == 3
    for name in os.listdir(tmp_path / 'jax'):
        assert (tmp_path / 'port' / name).read_bytes() == \
            (tmp_path / 'jax' / name).read_bytes()
    assert sorted(os.listdir(tmp_path / 'port')) == \
        sorted(os.listdir(tmp_path / 'jax'))


_GROUP = r'''
import sys
sys.path.insert(0, %(root)r)
import torch
import torch.distributed as dist
from archive_pdf_tools_tpu_torch.parallel.multihost import init_distributed
assert init_distributed('localhost:%(port)d', 2, int(sys.argv[1]))
x = torch.tensor([int(sys.argv[1]) + 1])
dist.all_reduce(x)
print(int(x), dist.get_world_size())
dist.destroy_process_group()
'''


def test_init_distributed(monkeypatch):
    for var in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        monkeypatch.delenv(var, raising=False)
    assert multihost.init_distributed() is False
    assert multihost.init_distributed('localhost:1', 1, 0) is False
    monkeypatch.setenv('MASTER_ADDR', 'localhost')
    assert multihost.init_distributed() is False       # WORLD_SIZE unset
    import socket
    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    code = _GROUP % {'root': ROOT, 'port': port}
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.split() == ['3', '2']


def _masks(path):
    from archive_pdf_tools_tpu_torch.codecs.jbig2 import decode_jbig2
    from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
    r = PdfReader(path)
    out = []
    for p in range(r.page_count()):
        for _, _, s in r.page_images(p):
            sm = r.resolve(s.dict.get('SMask'))
            if sm is not None:
                out.append(decode_jbig2(sm.raw,
                                        int(r.resolve(sm.dict['Width'])),
                                        int(r.resolve(sm.dict['Height']))))
    return out


def test_two_host_split_recode_matches_single(tmp_path):
    """tests/test_parallel.py's two-host split on the port: each host
    recodes its page range into its own artifact directory; the assembly
    host gathers them and resumes, and must give the single host's
    masks."""
    from tests.test_recode_e2e import J2K_BG, J2K_FG
    stack, hocr, _ = make_book(tmp_path, n_pages=2)
    kw = dict(from_imagestack=stack, hocr_file=hocr, dpi=100, jbig2=True,
              bg_compression_flags=[J2K_BG], fg_compression_flags=[J2K_FG],
              device='cpu')
    single = str(tmp_path / 'single.pdf')
    recode(out_pdf=single, **kw)
    dirs = []
    for hid in range(2):
        skip, count = multihost.host_stop_after(2, 2, hid)
        d = str(tmp_path / ('host%d' % hid))
        # recode() keeps the reference's stop_after off-by-one
        recode(out_pdf=str(tmp_path / ('h%d.pdf' % hid)), out_dir=d,
               skip_pages=skip, stop_after=count + 1, **kw)
        dirs.append((d, multihost.assign_page_range(2, 2, hid)[0]))
    merged = str(tmp_path / 'merged')
    multihost.gather_artifacts(dirs, merged)
    final = str(tmp_path / 'final.pdf')
    recode(out_pdf=final, out_dir=merged, resume=True, **kw)
    ms, mf = _masks(single), _masks(final)
    assert len(ms) == len(mf) == 2
    for a, b in zip(ms, mf):
        assert (a == b).all()


def _recode(tmp_path, monkeypatch, name, devices, impl, n_pages):
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    # the devices the pipeline would take from several visible cards
    monkeypatch.setattr(TR, 'default_devices',
                        lambda device: [torch.device(d) for d in devices])
    book = tmp_path / ('book%d' % n_pages)
    if not book.exists():
        book.mkdir()
        make_book(book, n_pages=n_pages, w=320, h=416, dpi=100)
    out = tmp_path / name
    res = recode(from_imagestack=str(book / 'page_*.png'),
                 hocr_file=str(book / 'book.hocr'), out_pdf=str(out),
                 dpi=100, jbig2=True, bg_downsample=3,
                 batch_pages=n_pages, jpeg2000_implementation=impl,
                 bg_compression_flags=['ratio:400'],
                 fg_compression_flags=['ratio:600'], device='cpu')
    assert res['compression_ratio'] > 1.0
    return out.read_bytes()


@pytest.mark.parametrize('impl', ['pillow', 'tpu'])
@pytest.mark.parametrize('n_pages,shards', [(8, 4), (6, 1)])
def test_recode_over_devices_byte_identical(tmp_path, monkeypatch, impl,
                                            n_pages, shards):
    """tests/test_pipeline_dp.py on the port: 8 pages go in two batches
    of 4, each split over 4 devices; 6 pages go in batches of 3, which
    do not split over 4 and run on one device.  Both give the one-device
    bytes."""
    seen = []
    real = sharded.sharded_optimise

    def spy(masks, images, n, invert=False):
        seen.append(len(masks))
        return real(masks, images, n, invert)

    one = _recode(tmp_path, monkeypatch, 'one.pdf', ['cpu'], impl, n_pages)
    monkeypatch.setattr(TA, 'sharded_optimise', spy)
    four = _recode(tmp_path, monkeypatch, 'four.pdf', ['cpu'] * 4, impl,
                   n_pages)
    assert set(seen) == {shards}
    assert one == four
