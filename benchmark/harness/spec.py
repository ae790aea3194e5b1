"""The benchmark's files, found by the names ``BENCHMARK.json`` gives.

- ``configs/<file>``: a configuration (named in ``BENCHMARK.json``), which
  names its scene generator (``scenes/<scene>.py``) and its plain reference
  (``reference/<reference>.py``);
- ``workloads/<traffic>.json``: a traffic mix;
- ``checks/<cell>.json``: what decides a cell's ``correct``;
- ``rooflines/<cell>.json``: a cell's frozen work counts (optional);
- ``metrics/<metric>.py``: one reader per measurement, ``read(run)``.  A
  metric named ``<metric>.<variant>`` (the same measurement in cells that
  report another end-to-end metric, which it moves) is read by
  ``metrics/<metric>.py`` unless a file of its own name is there.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, as a module."""
    path = os.path.join(BENCH_DIR, kind, name + '.py')
    if not os.path.exists(path):
        raise FileNotFoundError(f'no {kind} file {path}')
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The module that reads metric ``name`` (see the module's doc)."""
    own = os.path.join(BENCH_DIR, 'metrics', name + '.py')
    return load_module('metrics', name if os.path.exists(own)
                       else name.split('.')[0])


def spec_path(root: str = REPO_DIR) -> str:
    return os.path.join(root, 'BENCHMARK.json')


class Cell:
    """One cell of ``BENCHMARK.json`` with every file it names."""

    def __init__(self, name: str, spec: dict, root: str = REPO_DIR):
        cells = {w['name']: w for w in spec['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                           f'({", ".join(cells)})')
        self.name = name
        self.workload = cells[name]
        configs = {c['name']: c for c in spec['configs']}
        self.config = load_json(os.path.join(
            root, configs[self.workload['config']]['file']))
        self.traffic = load_json(os.path.join(
            BENCH_DIR, 'workloads', self.workload['traffic'] + '.json'))
        self.check = load_json(os.path.join(BENCH_DIR, 'checks',
                                            name + '.json'))
        rl = os.path.join(BENCH_DIR, 'rooflines', name + '.json')
        self.roofline = load_json(rl) if os.path.exists(rl) else None
        self.end_to_end = [m for m in spec['end_to_end']
                           if name in m.get('workloads', [name])]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in spec['per_layer']
                          if (name in m['workloads'] if 'workloads' in m
                              else m['moves'] in reported)]

    def scene(self):
        return load_module('scenes', self.config['scene'])

    def reference(self):
        return load_module('reference', self.config['reference'])
