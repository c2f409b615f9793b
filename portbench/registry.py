"""Finding a cell's parts by the names in ``BENCHMARK.json``.

    configuration   the ``file`` of its ``configs`` entry
                    (``portbench/configs/<name>.json``)
    traffic mix     ``portbench/traffic/<name>.json``
    metric          ``portbench/metrics/<name>.py``, a reader whose
                    ``read(run)`` returns the value, or None where it finds
                    nothing to read (the metric is then left out); its
                    unit, direction, source, layer and what it moves are
                    its ``BENCHMARK.json`` entry's

A cell is one ``workloads`` entry; adding one, or a metric, is adding
files and entries, never editing a file that is there.
"""

import importlib.util
import json
import os

from .traffic import generator

HERE = os.path.dirname(os.path.abspath(__file__))


class Benchmark:
    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, 'BENCHMARK.json')) as fp:
            self.spec = json.load(fp)
        self.here = os.path.join(root, 'portbench')

    def workload(self, name):
        for w in self.spec['workloads']:
            if w['name'] == name:
                return w
        raise KeyError('no workload %r in BENCHMARK.json' % name)

    def config(self, name):
        for c in self.spec['configs']:
            if c['name'] == name:
                with open(os.path.join(self.root, c['file'])) as fp:
                    return json.load(fp)
        raise KeyError('no configuration %r in BENCHMARK.json' % name)

    def traffic(self, name):
        return generator.load(os.path.join(self.here, 'traffic',
                                           name + '.json'))

    def metrics(self, trace):
        """{name: (entry, reader)} of the metrics a run reads: the
        end-to-end metrics in a ``--trace 0`` run, the per-layer metrics
        in a ``--trace 1`` run."""
        key = 'per_layer' if trace else 'end_to_end'
        return {m['name']: (m, self.reader(m['name'])) for m in self.spec[key]}

    def reader(self, name):
        path = os.path.join(self.here, 'metrics', name + '.py')
        spec = importlib.util.spec_from_file_location(
            'portbench.metrics.' + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
