"""Fixtures of the benchmark's tests: the checkout root on sys.path, a
temporary copy of the benchmark with a tiny cell, and the card."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_TRAFFIC = dict(pages=5, height=208, width=160, dpi=100, page_set=7,
                    rgb_pages=[4],
                    noise_sigma=9.0, format='png')
TTPU_TRAFFIC = dict(TINY_TRAFFIC, height=416, width=320, format='jp2',
                    jp2_rate=10)


def copy_benchmark(dst):
    """BENCHMARK.json and portbench/ (no build outputs) copied to dst."""
    shutil.copytree(os.path.join(ROOT, 'portbench'),
                    os.path.join(dst, 'portbench'),
                    ignore=shutil.ignore_patterns('.build', '__pycache__'))
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), dst)
    return dst


def add_cell(root, name, config, traffic, dpi=100, recode=None, like=None,
             **keys):
    """A tiny cell added as files and manifest entries: config ``name``
    (``config``'s flags at ``dpi``, those in ``recode`` replaced, its other
    ``keys`` replaced), traffic ``name`` and workload ``name.book``, listed
    in each metric's ``workloads`` that lists the cell ``like``."""
    with open(os.path.join(ROOT, 'portbench', 'configs',
                           config + '.json')) as fp:
        c = json.load(fp)
    c['recode']['dpi'] = dpi
    c['recode'].update(recode or {})
    c.update(keys)
    with open(os.path.join(root, 'portbench', 'configs',
                           name + '.json'), 'w') as fp:
        json.dump(c, fp)
    with open(os.path.join(root, 'portbench', 'traffic',
                           name + '.json'), 'w') as fp:
        json.dump(traffic, fp)
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as fp:
        bench = json.load(fp)
    bench['configs'].append({'name': name, 'source': 'test',
                             'file': 'portbench/configs/%s.json' % name,
                             'reduced': [], 'why': 'test'})
    bench['workloads'].append({'name': name + '.book', 'config': name,
                               'traffic': name, 'chips': 1, 'why': 'test'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if like in m.get('workloads', ()):
            m['workloads'].append(name + '.book')
    with open(path, 'w') as fp:
        json.dump(bench, fp)
    return name + '.book'


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with tiny cells ``tpil.book`` (Pillow
    layers) and ``ttpu.book`` (-J tpu, JPEG2000 pages).  ``ttpu``'s pages
    are larger, so that its layers keep some bytes at the coder's ratios,
    and its layer limits are its own: on the CPU the sound runs read
    fg_err 9.7-10.4 and bg_err 10.2-12.8, and the planted layer faults
    fg_err 42.7 or more (seeds 11-13)."""
    root = copy_benchmark(str(tmp_path / 'checkout'))
    add_cell(root, 'tpil', 'pillow_ds3', TINY_TRAFFIC,
             like='pillow_ds3.jp2book')
    add_cell(root, 'ttpu', 'jtpu', TTPU_TRAFFIC, like='jtpu.pngbook',
             layer_limits={'fg_err': 20.0, 'bg_err': 18.0})
    return root


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the run path on the card')
    return 'cuda:0'
