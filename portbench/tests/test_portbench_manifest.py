"""BENCHMARK.json against the contract's form: names, units, lengths,
bounds, the files it points at, and the readers of its metrics."""

import json
import os
import re

import pytest

from conftest import ROOT
from portbench.registry import Benchmark
from portbench.traffic import generator

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
PATH = re.compile(r'^[A-Za-z0-9_./-]{1,200}$')
SOURCES = ('device_trace', 'program_span', 'program_counter', 'host_clock')


@pytest.fixture(scope='module')
def bench():
    return Benchmark(ROOT)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and '\n' not in text and '\t' not in text


def test_keys_and_size(bench):
    spec = bench.spec
    assert set(spec) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) <= 64 * 1024
    assert 1 <= len(spec['command']) <= 32
    assert all(_line(w) for w in spec['command'])
    assert 1 <= len(spec['paths']) <= 16
    for p in spec['paths']:
        assert PATH.match(p) and not p.startswith('/') and '..' not in p
        assert not p.endswith('_torch')
    for w in spec['command']:
        if '/' in w:
            assert any(w.startswith(p + '/') for p in spec['paths'])


def test_run_seconds_fit_the_check():
    with open(os.path.join(ROOT, 'BENCHMARK.json')) as fp:
        rs = json.load(fp)['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(bench):
    spec = bench.spec
    names = []
    for c in spec['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['source']) and _line(c['why'])
        assert all(NAME.match(k) for k in c['reduced'])
        assert len(c['reduced']) <= 16
        assert c['file'].startswith(spec['paths'][0] + '/')
    for w in spec['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert all(NAME.match(w[k]) for k in ('name', 'config', 'traffic'))
        assert w['chips'] in (1, 4) and _line(w['why'])
    for key in ('end_to_end', 'per_layer'):
        for m in spec[key]:
            names.append(m['name'])
            assert NAME.match(m['name']) and UNIT.match(m['unit'])
            assert m['better'] in ('lower', 'higher')
            assert m['source'] in SOURCES
    for m in spec['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in spec['per_layer']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'source',
                                          'layer', 'moves'}
        assert _line(m['layer'])
    for group in ('configs', 'workloads'):
        group_names = [x['name'] for x in spec[group]]
        assert len(group_names) == len(set(group_names))
    assert len(names) == len(set(names))
    assert 'setup_s' in [m['name'] for m in spec['end_to_end']]


def test_every_cell_reports(bench):
    """Each cell: setup_s, another end-to-end metric, a per-layer metric,
    and the end-to-end metric each of its per-layer metrics moves.  A
    metric's ``workloads`` lists cells that exist; a per-layer metric
    without the list is reported by the cells of the metric it moves, an
    end-to-end metric without it by every cell."""
    spec = bench.spec
    used = {w['config'] for w in spec['workloads']}
    assert used == {c['name'] for c in spec['configs']}
    pairs = [(w['config'], w['traffic']) for w in spec['workloads']]
    assert len(pairs) == len(set(pairs))
    four = sum(w['chips'] == 4 for w in spec['workloads'])
    assert four <= max(1, len(spec['workloads']) // 4)
    cells = [w['name'] for w in spec['workloads']]
    e2e = bench.metrics(False)
    layer = bench.metrics(True)
    assert 'setup_s' in e2e and len(e2e) >= 2 and layer

    def reported(entry):
        listed = bench.cells(entry)
        assert listed and set(listed) <= set(cells), entry['name']
        assert len(listed) == len(set(listed)), entry['name']
        return set(listed)
    for name, (entry, _) in layer.items():
        assert entry['moves'] in e2e
        assert reported(entry) <= reported(e2e[entry['moves']][0]), name
    assert 'workloads' not in e2e['setup_s'][0]
    for cell in cells:
        assert sum(cell in reported(e) for e, _ in e2e.values()) >= 2
        assert any(cell in reported(e) for e, _ in layer.values())


def test_rate_end_to_end_or_per_layer(bench):
    """Each cell reports the window's rate once: end to end where its runs
    hold ``pages_per_s``'s bound, per layer in the others; and a run reads
    just the metrics its cell reports."""
    for w in bench.spec['workloads']:
        e2e = bench.metrics(False, w['name'])
        layer = bench.metrics(True, w['name'])
        assert ('pages_per_s' in e2e) != ('traced_pages_per_s' in layer)
        assert {'setup_s', 'bytes_per_page'} <= set(e2e)
        for key, got in (('end_to_end', e2e), ('per_layer', layer)):
            assert set(got) == {m['name'] for m in bench.spec[key]
                                if w['name'] in bench.cells(m)}


def test_files_and_readers(bench):
    spec = bench.spec
    for c in spec['configs']:
        cfg = bench.config(c['name'])
        assert cfg['name'] == c['name']
        assert set(c['reduced']) <= set(cfg['reduced'])
        assert cfg['guarantee'] and cfg['precision'] and cfg['recode']
    for w in spec['workloads']:
        traffic = bench.traffic(w['traffic'])
        assert traffic['pages'] >= 1
    for key in ('end_to_end', 'per_layer'):
        for m in spec[key]:
            assert callable(bench.reader(m['name']).read)


def test_traffic_file_is_checked(tmp_path):
    bad = tmp_path / 'bad.json'
    bad.write_text(json.dumps({'pages': 1}))
    with pytest.raises(ValueError):
        generator.load(str(bad))


def test_every_seed_has_the_same_pages():
    spec = dict(pages=6, rgb_pages=[5])
    a = generator.page_order(spec, 2 ** 40 + 7)
    assert a == generator.page_order(spec, 2 ** 40 + 7)
    assert sorted(a) == list(range(6)) and a[5] == 5
    orders = {tuple(generator.page_order(spec, s)) for s in range(20)}
    assert len(orders) > 10


def test_page_seeds_differ_and_repeat():
    a = [generator.page_seed(2 ** 40 + 7, i) for i in range(4)]
    assert a == [generator.page_seed(2 ** 40 + 7, i) for i in range(4)]
    assert len(set(a)) == 4
    assert a != [generator.page_seed(2 ** 40 + 8, i) for i in range(4)]
