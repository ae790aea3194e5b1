"""The readings a cell's ``px_err_mean`` limit is set from, on the card:
for each seed one frame of the program at the cell's own size (the timed
entry, as a run's window drives it), then, at the pixels a run compares,
the plain reference in float32 and the control (the same reference in
bfloat16, the precision below the configuration's float32).

    python3 benchmark/tools/control.py --workload box-final \
        --seeds 1 2 3 [--no-control]

prints one JSON line a seed: the program's ``px_err_mean`` against the
reference (the lower reading) and the control's (the upper reading), and
the seconds each side took.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from harness import bench, port, spec  # noqa: E402


def readings(cell, seed, device, control=True, overrides=None):
    import torch
    config = dict(cell.config, **(overrides or {}))
    desc = cell.scene().describe(config, seed)
    scene, meta = port.build(desc, device, config.get('accel', 'auto'))
    span = port.RegenSpan()
    try:
        t0 = time.perf_counter()
        img, samples = port.frame(scene, meta, cell.traffic)
        t_prog = time.perf_counter() - t0
    finally:
        span.close()
    del scene, meta
    gc.collect()
    frame = dict(iters=span.iters, samples=samples,
                 spp=int(cell.traffic['spp']))
    ids = bench.pixel_ids(cell, desc, seed)
    pid = torch.as_tensor(ids, device=device)
    ref = cell.reference()
    t0 = time.perf_counter()
    want = ref.expected(desc, pid, frame, device)
    out = dict(seed=seed, iters=span.iters, samples=samples,
               program=bench.px_err(img.reshape(-1, 4)[ids], want),
               program_s=t_prog, reference_s=time.perf_counter() - t0)
    if control:
        t0 = time.perf_counter()
        low = ref.expected(desc, pid, frame, device, dtype=torch.bfloat16)
        out.update(control=bench.px_err(low.float().cpu().numpy(), want),
                   control_s=time.perf_counter() - t0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--no-control', action='store_true')
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload, spec.load_json(spec.spec_path()))
    for s in a.seeds:
        print(json.dumps(readings(cell, s, 'cuda:0', not a.no_control)),
              flush=True)


if __name__ == '__main__':
    main()
