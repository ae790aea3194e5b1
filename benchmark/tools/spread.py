"""The spread of a cell's end-to-end metrics over repeated runs, and the
bound it suggests.

    python3 benchmark/tools/spread.py SET_A_FILES... -- SET_B_FILES...

Each file holds a run's standard output; its last line is the result.
For every metric: each set's median, quartiles and spread (the distance
between the quartiles of ``statistics.quantiles(values, n=4)`` as a share
of the median), the wider spread, five times it (at least 1%), the
second set's median against the first's, and every run's ``correct`` and
``px_err_mean``.
"""
from __future__ import annotations

import json
import os
import statistics
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from harness import stats  # noqa: E402


def results(paths):
    out = []
    for p in paths:
        with open(p) as f:
            lines = f.read().strip().splitlines()
        out.append(json.loads(lines[-1]))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cut = argv.index('--')
    sets = [results(argv[:cut]), results(argv[cut + 1:])]
    names = sorted(set(sets[0][0]['metrics']))
    report = {}
    for m in names:
        row = {}
        for k, runs in zip('AB', sets):
            v = [r['metrics'][m]['value'] for r in runs]
            q1, med, q3 = statistics.quantiles(v, n=4)
            row[k] = dict(median=med, q1=q1, q3=q3, spread=stats.spread(v),
                          values=v)
        wide = max(row['A']['spread'], row['B']['spread'])
        row['widest'] = wide
        row['bound_x5'] = max(0.01, 5.0 * wide)
        row['median_b_over_a'] = row['B']['median'] / row['A']['median']
        report[m] = row
    report['correct'] = [r['correct'] for s in sets for r in s]
    report['px_err_mean'] = [r['checks']['px_err_mean']['value']
                             for s in sets for r in s]
    print(json.dumps(report, indent=1))


if __name__ == '__main__':
    main()
