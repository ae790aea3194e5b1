"""One traced run of a cell, split by the port's spans.

    python3 benchmark/tools/span_split.py --workload <name> --seed <n> \
        --seconds <s> [--out FILE]

from the root of a checkout, on a CUDA card.  Runs the cell as
``benchmark/run.py --trace 1`` does (its result object is the last line
but one of standard output) and adds, from the same trace, each ``hc3.*``
span's count, the device milliseconds of the kernels launched inside it
and the launches made inside it, each per pass (``hc3.pass``) or, without
passes, per frame (``hc3.render``), and over the window the idle
milliseconds of the device inside it (``idle_ms``) and from inside it to
the device's next operation (``idle_from_ms``, what ``sync_idle_pct``
charges a blocking read).  The bounce stages are disjoint, as are the
gather sites; a gather site lies inside a stage.  The split is the last
line; ``--out`` also writes it to a file.

A kernel is found through the host operation that launched it, and a
kernel launched through ctypes (K1, K2, K3: the port's own CUDA kernels)
is linked to none: its device time is in no span, so the
``hc3.bounce.trace`` row leaves out the ray queries' kernels.  Whether
their launch calls are among the counted launches is not established.
"""
from __future__ import annotations

import json
import os
import sys
import time

T_START = time.perf_counter()

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from harness import bench, spans, spec  # noqa: E402
from harness.trace import TraceView  # noqa: E402


def split(tv):
    names = sorted({h[0] for h in tv.host if h[0].startswith('hc3.')})
    n_pass = spans.count(tv, 'hc3.pass')
    per, unit = ((n_pass, 'pass') if n_pass else
                 (spans.count(tv, 'hc3.render'), 'frame'))
    out = dict(per=unit, count=per, window_s=tv.window_s, busy_s=tv.busy_s,
               spans={})
    for n in names:
        out['spans'][n] = dict(
            count=spans.count(tv, n) / max(per, 1),
            device_ms=1e3 * spans.device_seconds_inside(tv, (n,))
            / max(per, 1),
            launches=spans.launches_inside(tv, (n,)) / max(per, 1),
            idle_ms=1e3 * spans.idle_seconds_inside(tv, (n,)),
            idle_from_ms=1e3 * spans.idle_seconds_from(tv, (n,)))
    return out


def main(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload, spec.load_json(spec.spec_path()))
    seen = []
    inner = TraceView.from_profiler

    def from_profiler(prof):
        seen.append(inner(prof))
        return seen[-1]

    bench.TraceView.from_profiler = from_profiler
    out = bench.run_cell(cell, args.seed, args.seconds, True, 'cuda:0',
                         T_START)
    print(json.dumps(out))
    res = dict(workload=args.workload, seed=args.seed, **split(seen[0]))
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
