"""The busy-share union, kernel sums and idle gaps on hand-made traces, and
the roofline's bytes and operations on hand-made shapes."""

import json

import pytest
from PIL import Image

from portbench import roofline
from portbench.trace import Trace, merge


def _ev(name, cat, ts, dur, tid=1):
    return {'ph': 'X', 'name': name, 'cat': cat, 'ts': ts, 'dur': dur,
            'tid': tid}


def _trace():
    return Trace([
        _ev('book 0', 'user_annotation', 1000, 1000),
        _ev('book 1', 'user_annotation', 2000, 1000),
        _ev('k1', 'kernel', 900, 200),        # clipped to [1000, 1100]
        _ev('k2', 'kernel', 1050, 100),       # overlaps k1: union 1000-1150
        _ev('k1', 'kernel', 1500, 100),
        _ev('k3', 'kernel', 2900, 300),       # clipped to [2900, 3000]
        _ev('k4', 'kernel', 5000, 10),        # outside the window
        _ev('aten::to', 'cpu_op', 1150, 300),
        _ev('aten::copy_', 'cpu_op', 1160, 100),
        _ev('aten::mul', 'cpu_op', 1600, 1300, tid=2),   # another thread
        _ev('cudaLaunchKernel', 'cuda_runtime', 1100, 5),
    ])


def test_merge():
    assert merge([(3, 4), (1, 2), (2, 3), (6, 7)]) == [[1, 4], [6, 7]]
    assert merge([]) == []


def test_busy_union_and_sums():
    t = _trace()
    assert t.window_s == pytest.approx(2000e-6)
    assert t.busy_s() == pytest.approx((150 + 100 + 100) * 1e-6)
    assert t.kernel_s() == pytest.approx((100 + 100 + 100 + 100) * 1e-6)
    assert t.by_kernel() == [['k1', pytest.approx(200e-6)],
                             ['k2', pytest.approx(100e-6)],
                             ['k3', pytest.approx(100e-6)]]


def test_idle_gaps_and_labels():
    gaps = _trace().idle_gaps()
    # 1600-2900 (1300), 1150-1500 (350)
    assert [g[1] for g in gaps] == [pytest.approx(1300e-6),
                                    pytest.approx(350e-6)]
    assert gaps[0][0].startswith('book 1: ')
    assert gaps[1][0] == 'book 0: aten::to'
    assert 'no torch op' in gaps[0][0]     # tid 2's op is not the main's


def test_trace_needs_book_spans(tmp_path):
    p = tmp_path / 't.json'
    p.write_text(json.dumps({'traceEvents': [_ev('k', 'kernel', 0, 1)]}))
    with pytest.raises(ValueError):
        Trace.load(str(p))


def test_roofline_bytes_and_ops():
    flags = {'bg_downsample': 3, 'jpeg2000_implementation': 'pillow'}
    nb, ops = roofline.page_work((30, 16), [(0, 0, 10, 5)], 9.0, flags)
    fg = 30 * 16
    bw, bh = roofline.thumb(16, 30, 3)
    im = Image.new('L', (16, 30))
    im.thumbnail((16 // 3, 30 // 3))
    assert (bw, bh) == im.size == (5, 9)
    assert nb == 30 * 16 + 30 * 2 + fg + bw * bh
    r = roofline.blur_radius(9.0)
    assert r == 4
    o = roofline.OPS
    want = 30 * 16 * (4 * (2 * r + 1) + o['sauvola'] + o['paste']
                      + o['despeckle'] + 2 * o['fill'])
    want += 15 * 8 * o['noise'] + 2 * 50 * o['sauvola']
    want += 2 * 12 * (30 * 5 + 9 * 5)
    assert ops == want
    nb2, ops2 = roofline.page_work((30, 16), [], 9.0,
                                   dict(flags, jpeg2000_implementation='tpu'))
    assert nb2 == nb + 2 * (fg + bw * bh)
    assert ops2 > ops - 2 * 50 * o['sauvola']


def test_least_seconds_takes_the_larger():
    peak = roofline.DEFAULT_PEAK
    t, which = roofline.least_seconds(3.35e12, 1.0, peak)
    assert (t, which) == (pytest.approx(1.0), 'bytes')
    t, which = roofline.least_seconds(1.0, 134e12, peak)
    assert (t, which) == (pytest.approx(2.0), 'operations')
    assert roofline.peak('NVIDIA H100 80GB HBM3') is peak
    assert roofline.peak('cpu') is None
