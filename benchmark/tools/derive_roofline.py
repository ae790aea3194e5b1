"""Derive a K1 cell's work count per sample, once, with the port's counting
build of K1 (``-DHC3_COUNT``: every lane's Woop tests, child-box tests and
shades by material kind), on the cell's own inputs, outside any window.

    python3 benchmark/tools/derive_roofline.py --workload box-final \
        --seeds 11 12 13 [--write]

prints the roofline object (and with ``--write`` writes it to
``benchmark/rooflines/<workload>.json``).  The benchmark's runs never run
this: they read the frozen file.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), os.path.dirname(os.path.dirname(HERE))]

from harness import port, spec  # noqa: E402

# float32 operations a test or a shade costs, counted from
# csrc/megakernel.cu (each add, multiply, divide, compare, min/max, sqrt,
# rsqrt, sin, cos and atan2 one): a Woop test, a child-box (slab) test, and
# a shade by the hit's material kind (the counting build's counters 2-7)
WOOP_OPS = 45
SLAB_OPS = 25
SHADE_KINDS = ('gltf', 'diffuse', 'conductor', 'dielectric', 'glass', 'light')
SHADE_OPS = {'gltf': 1100, 'diffuse': 690, 'conductor': 1140,
             'dielectric': 550, 'glass': 530, 'light': 180}
# a persistent-lane launch reads and writes each lane's state once: 30 f32
# and 5 int64 rows in, the same out, and its pixel's 2 f32 coordinates
LANE_STATE_BYTES = 2 * (30 * 4 + 5 * 8) + 2 * 4
# K3 / K2: a grid cell's exit planes and step; a ray query reads a ray
# (origin, direction, t range: 32 B) and writes its hit (t, id, u, v: 16 B)
CELL_OPS = 20
RAY_IO_BYTES = 32 + 16


def _nbytes(obj) -> int:
    """Bytes of the tensors an object (a table pack) holds."""
    import torch
    items = vars(obj).values() if hasattr(obj, '__dict__') else (
        getattr(obj, f) for f in getattr(obj, '_fields', ()))
    return sum(t.numel() * t.element_size() for t in items
               if torch.is_tensor(t))


def derive_k1(cell, seed):
    import torch
    from hydracore3_torch.models import megakernel as MK
    desc = cell.scene().describe(cell.config, seed)
    scene, meta = port.build(desc, 'cuda')
    pk = MK.pack(scene, meta)
    variant = MK.variant_of(pk, MK.INTEGRATOR_BY_NAME[
        cell.traffic['integrator']])
    lib, _ = MK.load_library(MK.variant_defines(variant) + ('HC3_COUNT',))
    w = pk.wide
    table_bytes = sum(t.numel() * t.element_size() for t in (
        w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light, pk.tex,
        pk.consts, pk.texels))
    lanes = -(-meta.width * meta.height // MK.RBLK) * MK.RBLK
    span = port.RegenSpan()
    MK._lib = lib
    try:
        lib.hc3_mega_counts_reset()
        _, samples = port.frame(scene, meta, cell.traffic)
        torch.cuda.synchronize()
        buf = (ctypes.c_uint64 * 8)()
        lib.hc3_mega_counts_read(buf)
    finally:
        MK._lib = None
        span.close()
    c = [int(x) for x in buf]
    ops = (c[0] * WOOP_OPS + c[1] * SLAB_OPS
           + sum(n * SHADE_OPS[k] for n, k in zip(c[2:], SHADE_KINDS)))
    nbytes = span.calls * (lanes * LANE_STATE_BYTES + table_bytes)
    return dict(seed=seed, samples=samples, launches=span.calls,
                iterations=span.iters, woop_tests=c[0], box_tests=c[1],
                shades=dict(zip(SHADE_KINDS, c[2:])), ops=ops, bytes=nbytes,
                ops_per_sample=ops / samples,
                bytes_per_sample=nbytes / samples)


def derive_trace(cell, seed):
    """K3's and K2's work in one frame of the batched route: the counting
    build of csrc/traverse.cu (box tests, Woop tests, grid cells), each
    launch's rays in and hits out and its tables once."""
    import torch
    from hydracore3_torch.accel import traverse_dda as TDD
    from hydracore3_torch.accel import traverse_stream as TST
    desc = cell.scene().describe(cell.config, seed)
    scene, meta = port.build(desc, 'cuda', cell.config.get('accel', 'auto'))
    lib, _ = TST.load_library(('HC3_COUNT',))
    shipped = TST.kernel_library()
    l0 = TDD.intersect_march.launches + TST.intersect_stream.launches
    TST._lib = lib
    try:
        lib.hc3_counts_reset()
        _, samples = port.frame(scene, meta, cell.traffic)
        torch.cuda.synchronize()
        buf = (ctypes.c_uint64 * 4)()
        lib.hc3_counts_read(buf)
    finally:
        TST._lib = shipped
    launches = (TDD.intersect_march.launches + TST.intersect_stream.launches
                - l0)
    c = [int(x) for x in buf]
    ops = c[0] * SLAB_OPS + c[1] * WOOP_OPS + c[3] * CELL_OPS
    table_bytes = _nbytes(scene.st_wide) + _nbytes(scene.st_grid)
    lanes = meta.width * meta.height
    nbytes = launches * (lanes * RAY_IO_BYTES + table_bytes)
    return dict(seed=seed, samples=samples, launches=launches, box_tests=c[0],
                woop_tests=c[1], cells=c[3], ops=ops, bytes=nbytes,
                table_bytes=table_bytes, ops_per_sample=ops / samples,
                bytes_per_sample=nbytes / samples)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    ap.add_argument('--write', action='store_true')
    a = ap.parse_args(argv)
    cell = spec.Cell(a.workload, spec.load_json(spec.spec_path()))
    k1 = cell.traffic['route'] == 'megakernel'
    rows = [(derive_k1 if k1 else derive_trace)(cell, s) for s in a.seeds]
    how_k1 = ('the counting build of K1 (-DHC3_COUNT) over one frame of the '
              'cell on each seed below; operations = Woop tests x '
              f'{WOOP_OPS} + child-box tests x {SLAB_OPS} + shades x their '
              'kind\'s operations; bytes = each launch\'s lane state in and '
              f'out ({LANE_STATE_BYTES} B a lane) and its tables once')
    how_tr = ('the counting build of csrc/traverse.cu (-DHC3_COUNT) over one '
              'frame of the cell on each seed below, every K3 and K2 launch '
              f'in it; operations = child-box tests x {SLAB_OPS} + Woop tests '
              f'x {WOOP_OPS} + grid cells x {CELL_OPS}; bytes = each '
              f'launch\'s rays in and hits out ({RAY_IO_BYTES} B a lane) and '
              'its tables (scene.st_wide, scene.st_grid) once')
    out = dict(
        kernel='K1' if k1 else 'K3+K2',
        ops_peak='fp32_nofma_ops_per_s' if k1 else 'fp32_ops_per_s',
        ops_per_sample=sum(r['ops_per_sample'] for r in rows) / len(rows),
        bytes_per_sample=sum(r['bytes_per_sample'] for r in rows) / len(rows),
        derivation=dict(how=(how_k1 if k1 else how_tr) + '; both over the '
                        'frame\'s samples, the mean over the seeds',
                        per_seed=rows, **(dict(shade_ops=SHADE_OPS) if k1
                                         else {})))
    text = json.dumps(out, indent=1)
    print(text)
    if a.write:
        with open(os.path.join(spec.BENCH_DIR, 'rooflines',
                               a.workload + '.json'), 'w') as f:
            f.write(text + '\n')


if __name__ == '__main__':
    main()
