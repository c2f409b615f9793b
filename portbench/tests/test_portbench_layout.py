"""What the benchmark loads, and that an addition is files alone: a dummy
configuration, traffic mix and metric added to a temporary copy are
found by name."""

import json
import os
import subprocess
import sys

from conftest import ROOT, TINY_TRAFFIC, add_cell, copy_benchmark
from portbench.registry import Benchmark

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'archive_pdf_tools_tpu')

_PROBE = r'''
import sys
sys.path.insert(0, %(root)r)
%(body)s
tops = {m.split('.')[0] for m in list(sys.modules)}
print(sorted(tops & {%(names)s}))
'''


def _probe(body, names=FORBIDDEN):
    code = _PROBE % {'root': ROOT, 'body': body,
                     'names': ', '.join(repr(n) for n in names)}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process, then the modules it holds,
    compared by whole top-level names (the port's name starts with the
    JAX package's)."""
    body = ('from portbench.run import run_cell\n'
            'assert run_cell("tpil.book", 3, 0.0, True, root=%r, '
            'device="cpu") == 0' % tiny_root)
    assert _probe(body) == '[]'


def test_reference_imports_nothing_of_the_program():
    body = ('import portbench.judge, portbench.control, portbench.trace, '
            'portbench.roofline\n'
            'import portbench.reference.mrc, portbench.reference.pdfread, '
            'portbench.reference.jbig2, portbench.reference.denoise_fast, '
            'portbench.reference.denoise_none')
    names = FORBIDDEN + ('archive_pdf_tools_tpu_torch',)
    assert _probe(body, names) == '[]'


def test_additions_are_files(tmp_path):
    root = copy_benchmark(str(tmp_path))
    name = add_cell(root, 'dummy', 'jtpu', TINY_TRAFFIC)
    with open(os.path.join(root, 'portbench', 'metrics',
                           'dummy_metric.py'), 'w') as fp:
        fp.write('def read(run):\n    return 42.0\n')
    path = os.path.join(root, 'BENCHMARK.json')
    with open(path) as fp:
        spec = json.load(fp)
    spec['per_layer'].append({'name': 'dummy_metric', 'unit': '%',
                              'better': 'higher', 'source': 'device_trace',
                              'layer': 'device (H100)',
                              'moves': 'pages_per_s'})
    with open(path, 'w') as fp:
        json.dump(spec, fp)
    bench = Benchmark(root)
    assert bench.config('dummy')['recode']['dpi'] == 100
    assert bench.traffic('dummy')['pages'] == TINY_TRAFFIC['pages']
    assert bench.workload(name)['config'] == 'dummy'
    metrics = bench.metrics(True)
    assert metrics['dummy_metric'][1].read(None) == 42.0
    assert 'dummy_metric' not in bench.metrics(False)


def test_bare_directory_gives_no_result(tmp_path):
    """BENCHMARK.json and the benchmark's files alone: a nonzero exit and
    no result line."""
    root = copy_benchmark(str(tmp_path))
    r = subprocess.run([sys.executable, 'portbench/run.py', '--workload',
                        'jtpu.pngbook', '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=root, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=''))
    assert r.returncode != 0
    assert r.stdout.strip() == ''
