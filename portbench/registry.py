"""Finding a cell's parts by the names in ``BENCHMARK.json``.

    configuration   the ``file`` of its ``configs`` entry
                    (``portbench/configs/<name>.json``)
    traffic mix     ``portbench/traffic/<name>.json``
    metric          ``portbench/metrics/<name>.py``, a reader whose
                    ``read(run)`` returns the value, or None where it finds
                    nothing to read (the metric is then left out); its
                    unit, direction, source, layer and what it moves are
                    its ``BENCHMARK.json`` entry's
    denoise mode    ``portbench/reference/denoise_<mode>.py``, the
                    reference's last mask stage for a configuration's
                    ``denoise_mask`` (``reference/mrc.py`` ``denoiser``)

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

    def metrics(self, trace, cell=None):
        """{name: (entry, reader)} of the metrics a run reads: the
        end-to-end metrics in a ``--trace 0`` run, the per-layer metrics
        in a ``--trace 1`` run; given a cell, only those it reports."""
        key = 'per_layer' if trace else 'end_to_end'
        return {m['name']: (m, self.reader(m['name'])) for m in self.spec[key]
                if cell is None or cell in self.cells(m)}

    def cells(self, entry):
        """The cells that report a metric: its ``workloads``; without
        them, those of the end-to-end metric it moves, or every cell."""
        if 'workloads' in entry:
            return entry['workloads']
        for m in self.spec['end_to_end']:
            if m['name'] == entry.get('moves'):
                return self.cells(m)
        return [w['name'] for w in self.spec['workloads']]

    def reader(self, name):
        path = os.path.join(self.here, 'metrics', name + '.py')
        spec = importlib.util.spec_from_file_location(
            'portbench.metrics.' + name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
