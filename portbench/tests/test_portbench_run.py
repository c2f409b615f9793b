"""The whole run path on a tiny book on the CPU (the plain path of the
port), its result line, and ``correct`` coming out false with the timed
path broken underneath: a mask altered where it is produced, half of a
batch left out, a stage that returns its input unchanged, a written book
corrupted.  (A one-chip cell has no exchange between chips to leave
out.)"""

import io
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import faults
from portbench.run import run_cell

import archive_pdf_tools_tpu_torch.pipeline.recode as recode_mod


def _run(root, workload, trace=False, device='cpu'):
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(workload, 12345678901234, 0.0, trace, root=root,
                  device=device, out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_tiny_book_correct(tiny_root):
    rc, res, err = _run(tiny_root, 'tpil.book')
    assert rc == 0, err
    assert list(res)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(res)[-1] == 'checks'
    assert res['correct'] is True
    assert res['attempted'] == 5 and res['failed'] == 0
    assert set(res['metrics']) == {'pages_per_s', 'bytes_per_page', 'setup_s'}
    assert res['checks']['mask_mismatch'] == {'value': 0.0, 'limit': 0.0}
    assert set(res['checks']) >= {'differing_books', 'pdf_faults',
                                  'text_faults', 'fg_gap', 'bg_gap'}
    # the numbers compared are stderr's last lines
    tail = err.strip().splitlines()[-len(res['checks']):]
    assert all(line.startswith('check ') for line in tail)


def test_tiny_book_traced_jtpu(tiny_root):
    rc, res, err = _run(tiny_root, 'ttpu.book', trace=True)
    assert rc == 0, err
    assert res['correct'] is True
    m = res['metrics']
    assert {'image_load_ms', 'mrc_stages_ms', 'encode_ms'} <= set(m)
    assert 'pages_per_s' not in m
    assert {'fg_err', 'bg_err', 'mask_mismatch'} <= set(res['checks'])
    assert res['device']['window_s'] > 0
    assert 'breakdown' in res


# each case: the cell it runs and the fault planted (``faults.FAULTS``)
BROKEN = {
    'altered': ('tpil', 'mask_altered'),
    'half': ('tpil', 'mask_half'),
    'unchanged': ('tpil', 'despeckle_unchanged'),
    'corrupted': ('tpil', None),
    'fill_unchanged': ('ttpu', 'fill_unchanged'),
    'b7_zero': ('ttpu', 'b7_zero'),
    'quant_step': ('ttpu', 'quant_step'),
    't1_drop_ll': ('ttpu', 't1_drop_ll'),
}


@pytest.mark.parametrize('fault', list(BROKEN))
def test_broken_path_is_not_correct(tiny_root, monkeypatch, fault):
    cell, planted = BROKEN[fault]
    if planted is None:
        real = recode_mod.recode

        def recode(*args, out_pdf=None, **kw):
            r = real(*args, out_pdf=out_pdf, **kw)
            if os.path.basename(out_pdf).startswith('book_'):
                with open(out_pdf, 'r+b') as fp:
                    fp.seek(os.path.getsize(out_pdf) // 2)
                    fp.write(b'\x00' * 16)
            return r
        monkeypatch.setattr(recode_mod, 'recode', recode)
        rc, res, err = _run(tiny_root, cell + '.book')
    else:
        with faults.plant(planted):
            rc, res, err = _run(tiny_root, cell + '.book')
    assert rc == 0, err
    assert res['correct'] is False


def test_two_recodes_give_equal_bytes(tmp_path, monkeypatch):
    from portbench.traffic import generator
    from conftest import TINY_TRAFFIC
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '1700000000')
    book = generator.make_book(TINY_TRAFFIC, 77, str(tmp_path / 'b'),
                               workers=2)
    outs = []
    for k in range(2):
        path = str(tmp_path / ('o%d.pdf' % k))
        recode_mod.recode(from_imagestack=book.glob, hocr_file=book.hocr,
                          out_pdf=path, dpi=100, bg_downsample=3, jbig2=True,
                          resume=False, device='cpu')
        with open(path, 'rb') as fp:
            outs.append(fp.read())
    assert outs[0] == outs[1]


def test_same_seed_same_book(tmp_path):
    from portbench.traffic import generator
    from conftest import TINY_TRAFFIC
    a = generator.make_book(TINY_TRAFFIC, 5, str(tmp_path / 'a'), workers=1)
    b = generator.make_book(TINY_TRAFFIC, 5, str(tmp_path / 'b'), workers=1)
    for fa, fb in zip(a.files, b.files):
        with open(fa, 'rb') as x, open(fb, 'rb') as y:
            assert x.read() == y.read()
    assert a.boxes == b.boxes


def test_pages_come_from_the_cache(tmp_path):
    """A second book of one traffic file writes no page: it links the
    cached variants, in its own seed's order."""
    from portbench.traffic import generator
    from conftest import TINY_TRAFFIC
    cache = str(tmp_path / 'cache')
    a = generator.make_book(TINY_TRAFFIC, 5, str(tmp_path / 'a'), workers=2,
                            cache_dir=cache)
    maker = generator.BookMaker(TINY_TRAFFIC, 6, str(tmp_path / 'b'),
                                cache_dir=cache)
    assert maker.pool is None
    b = maker.wait()
    assert sorted(map(os.path.realpath, a.files)) == \
        sorted(map(os.path.realpath, b.files))
    assert sorted(a.boxes) == sorted(b.boxes)
    fresh = generator.make_book(TINY_TRAFFIC, 6, str(tmp_path / 'c'),
                                workers=2)
    for fb, fc in zip(b.files, fresh.files):
        with open(fb, 'rb') as x, open(fc, 'rb') as y:
            assert x.read() == y.read()
    assert b.boxes == fresh.boxes


def test_control_is_not_correct(tiny_root):
    """The bf16 control, judged as a run is, comes out not correct on
    three seeds: it fails the mask number."""
    from portbench import control, judge
    from portbench.registry import Benchmark
    from portbench.traffic.generator import make_book
    bench = Benchmark(tiny_root)
    config = bench.config('tpil')
    spec = dict(bench.traffic('tpil'), height=416, width=320)
    for seed in (11, 12, 13):
        book = make_book(spec, seed,
                         os.path.join(tiny_root, 'c%d' % seed), workers=2)
        checks, correct = judge.verdict(
            control.readings(book, config, seed, torch.device('cpu')), config)
        assert correct is False
        assert checks['mask_mismatch'][0] > checks['mask_mismatch'][1]


def test_card_run(tiny_root, cuda_device):
    rc, res, err = _run(tiny_root, 'tpil.book', device=None)
    assert rc == 0, err
    assert res['correct'] is True and res['device']['platform'] == 'gpu'
    assert np.isfinite(res['metrics']['pages_per_s']['value'])
