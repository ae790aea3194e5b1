#!/usr/bin/env python3
"""Time K6, the cell pass under ``intersect_dda``, on one CUDA card, with
its design variants.

    python3 scripts/k6_measure.py [--reps 9] [--variants V1,V2,...]

On the bench city (``synth.city_scene(width=1024, height=1024, depth=5,
textured=True)``) over its grid without outliers
(``traverse_dda.pack_grid(..., robust_aabb=False)``), two nearest queries of
1,048,576 lanes each, built as ``chip_smoke.py`` builds them: the camera
rays and the first-bounce rays sorted as the pass sorts them.  For each
variant and query: the whole query's milliseconds (CUDA events around the
call, which waits on the counts it reads), the launches' summed
milliseconds (CUDA events around each launch, in calls of their own, each
launch's start event queued behind a spin of ``PAD_CYCLES`` on the card,
so that the host's time to submit the launch is not counted as the
kernel's), the live lanes after each counted round, and whether its
answers (t, tri, u, v) equal ``intersect_dda``'s on every lane.  The
shipped variant's whole query is ``intersect_dda`` itself; the launches of
``intersect_dda`` as its own ``stats['kernel_ms']`` times them (no spin,
as ``chip_smoke.py`` reads them) are printed beside.  Every variant is warmed up
first, then each rep times every variant once in turn, so that a drift of
the card's clocks falls on all of them alike; the medians of ``--reps``
reps are reported.

Variants of the host loop (all on the shipped library), each changing one
thing of the shipped ``intersect_dda``, which runs the entry in the first
launch, every launch over all N lanes (lanes done return at once), and
reads the count after every ``READ_EVERY``-th (8th) launch, the launches
between blind:
  everyK       the count read after every K-th launch (K = 1, 2, 4, 16);
  gathered     the count read after every launch, and each launch after the
               first over the live lanes alone: their rays and state
               gathered into dense arrays by eager torch ops before it and
               scattered back after it.  Its launches are a best case of
               compacting the live lanes (contiguous loads, no index list),
               so their summed time, not the whole query, is what compares;
  sorted       as gathered, the live lanes in cell order (a torch argsort, as
               the JAX round loop sorts its lanes), so a warp's lanes walk
               the same subtrees;
  eager_entry  the entry as eager torch ops (``dda_entry``) before the first
               launch.
Variants of the kernel (``csrc/traverse.cu`` changed by text substitution,
built beside the shipped library and run through ``intersect_dda``):
  minblocksN   ``cell_pass_kernel`` under ``__launch_bounds__(128, N)``;
  block64, block256  every kernel of the source with 64 / 256 threads a
               block.
It also prints each launch's milliseconds of the shipped loop and of
``gathered``, with the count read after every launch so that each round's
live lanes show beside it.
The last line is a JSON record of everything measured.
"""
import argparse
import concurrent.futures
import json
import os
import re
import statistics
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hydracore3_torch.accel import traverse_dda as TDD  # noqa: E402
from hydracore3_torch.accel import traverse_stream as TST  # noqa: E402
from hydracore3_torch.utils.native import BUILD_DIR  # noqa: E402

HOST_VARIANTS = {'every1': dict(every=1), 'every2': dict(every=2),
                 'every4': dict(every=4), 'every16': dict(every=16),
                 'gathered': dict(every=1, gather=True),
                 'sorted': dict(every=1, gather=True, sort=True),
                 'eager_entry': dict(eager=True)}
# a spin of about 0.1 ms on the card before each timed launch
PAD_CYCLES = 200_000
KERNEL_VARIANTS = ('minblocks2', 'minblocks4', 'minblocks6', 'minblocks8',
                   'block64', 'block256')


def log(msg):
    print(msg, flush=True)


def variant_source(name: str) -> str:
    """``csrc/traverse.cu`` changed as kernel variant ``name`` says, written
    beside the build; returns its path."""
    with open(TST._CU_SRC) as f:
        src = f.read()
    m = re.fullmatch(r'minblocks(\d+)', name)
    if m:
        old = '__global__ void __launch_bounds__(BLOCK)\ncell_pass_kernel('
        new = (f'__global__ void __launch_bounds__(BLOCK, {m.group(1)})\n'
               'cell_pass_kernel(')
    elif name in ('block64', 'block256'):
        old = 'constexpr int BLOCK = 128;'
        new = f'constexpr int BLOCK = {name[5:]};'
    else:
        raise ValueError(f'unknown kernel variant {name}')
    if old not in src:
        raise RuntimeError(f'{name}: the source has no {old!r}')
    out = os.path.join(BUILD_DIR, 'k6_variants')
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f'traverse_{name}.cu')
    with open(path, 'w') as f:
        f.write(src.replace(old, new))
    return path


def host_loop(grid, wide, q, timed, every=TDD.READ_EVERY, gather=False,
              sort=False, eager=False, max_rounds=48):
    """``intersect_dda``'s loop on the card, with the count read after every
    ``every``-th launch, each launch after the first over the live lanes
    gathered into dense arrays (``gather``, needs ``every=1``), in cell
    order (``sort``), the entry as eager torch ops (``eager``); the
    defaults are ``intersect_dda``'s.  Returns ((t, tri, u, v), live lanes
    after each counted round, each launch's ms or None when not
    ``timed``; a timed launch waits behind a spin of ``PAD_CYCLES``)."""
    rays = TST.ray_arrays('k6_measure', *q)
    dev, N = rays[0].device, rays[0].shape[0]
    if eager:
        state = TDD.dda_entry(grid, *rays[:3],
                              torch.clamp(rays[3], max=TST.T_MAX_CAP))
    else:
        state = TDD.empty_state(N, dev)
    counts = torch.zeros(max_rounds, dtype=torch.int32, device=dev)
    d1, d2 = grid.dims[1], grid.dims[2]
    rounds, live, seen, events = 0, N, [], []
    while rounds < max_rounds and live > 0:
        r_on, s_on = rays, state
        if gather and rounds > 0:
            idx = (state.done == 0).nonzero().squeeze(1)
            if sort:
                c = state.cell[idx].long()
                idx = idx[torch.argsort((c[:, 0] * d1 + c[:, 1]) * d2
                                        + c[:, 2])]
            r_on = tuple(x[idx] for x in rays)
            s_on = TDD.DdaState(*(x[idx] for x in state))
        if timed:
            torch.cuda._sleep(PAD_CYCLES)
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        TDD.cell_pass(grid, wide, r_on, s_on, counts[rounds:rounds + 1],
                      first=rounds == 0 and not eager)
        if timed:
            events[-1][1].record()
        if s_on is not state:
            for a, b in zip(state, s_on):
                a[idx] = b
        rounds += 1
        if rounds % every == 0 or rounds == max_rounds:
            live = int(counts[rounds - 1])
            seen.append(live)
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in events] if timed else None
    return tuple(state[3:]), seen, ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--reps', type=int, default=9)
    ap.add_argument('--variants', default=','.join([*HOST_VARIANTS,
                                                    *KERNEL_VARIANTS]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('k6_measure: no CUDA device')
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import synth
    dev = torch.device('cuda:0')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    variants = [v for v in args.variants.split(',') if v]
    kernel_vs = [v for v in variants if v not in HOST_VARIANTS]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        jobs = {v: pool.submit(TST.load_library, (), variant_source(v))
                for v in kernel_vs}
        TST.build_kernels()
        libs = {v: j.result()[0] for v, j in jobs.items()}
    shipped_lib = TST.kernel_library()
    record = {'card': card, 'attrs': {
        v: {k: a for k, a in TST.kernel_attrs(lib).items()
            if k.startswith('cell_pass')}
        for v, lib in [('shipped', shipped_lib), *libs.items()]}}
    log(f'registers, local bytes: {record["attrs"]}')

    scene, meta = synth.city_scene(width=1024, height=1024, depth=5,
                                   textured=True, device=dev)
    grid = TDD.pack_grid(scene.st_nodes_f.cpu().numpy(),
                         scene.st_nodes_i.cpu().numpy(),
                         robust_aabb=False).to(dev)
    wide = scene.st_wide
    N = meta.width * meta.height
    pix = torch.arange(N, device=dev)
    st = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)

    def nearest_q(state):
        live = ~IPT._is_dead(state.flags)
        return (state.ray_pos, state.ray_dir, torch.zeros(N, device=dev),
                torch.where(live, IPT.LM.FLT_MAX, 0.0))

    queries = {'camera': nearest_q(st)}
    st = IPT.kernel_ray_trace(scene, meta, st, 0)
    ctx = IPT.MAT.make_shading_ctx(scene, meta, IPT._extract_mat_id(st.flags),
                                   st.hit_norm, st.hit_tang, st.hit_uv)
    shade, rng2 = IPT.kernel_sample_light_source(scene, meta, st, ctx)
    st = IPT.kernel_next_bounce(scene, meta, st._replace(rng=rng2), 0, shade,
                                ctx)
    st, _ = IPT._sort_rays_for_trace(st, pix, scene.st_grid)
    queries['bounce'] = nearest_q(st)
    del st, ctx, shade

    def shipped_run(timed):
        if timed:
            return host_loop(grid, wide, q, True)
        return TDD.intersect_dda(grid, None, *q, wide=wide), [], None

    def stats_ms():
        stats = {}
        TDD.intersect_dda(grid, None, *q, stats=stats, wide=wide)
        return stats['kernel_ms']

    def kernel_run(v):
        def run(timed):
            TST._lib = libs[v]
            try:
                return shipped_run(timed)
            finally:
                TST._lib = shipped_lib
        return run

    def whole_ms(run):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(False)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    record['queries'] = {}
    for label, q in queries.items():
        runs = {'shipped': shipped_run}
        for v in variants:
            runs[v] = ((lambda timed, v=v: host_loop(
                grid, wide, q, timed, **HOST_VARIANTS[v]))
                if v in HOST_VARIANTS else kernel_run(v))
        outs = {v: run(False) for v, run in runs.items()}     # warm-up
        whole = {v: [] for v in runs}
        ksum = {v: [] for v in runs}
        for _ in range(args.reps):
            for v, run in runs.items():
                whole[v].append(whole_ms(run))
        for _ in range(args.reps):
            for v, run in runs.items():
                ksum[v].append(sum(run(True)[2]))
        unpadded = [stats_ms() for _ in range(args.reps)]
        log(f'{label} intersect_dda stats[kernel_ms] (no spin): '
            f'{statistics.median(unpadded):.3f} ms ('
            + ', '.join(f'{x:.3f}' for x in unpadded) + ')')
        res = {'stats_kernel_ms': unpadded}
        for how, kw in (('rounds', {}), ('rounds_gathered',
                                         dict(gather=True))):
            _, seen, per = host_loop(grid, wide, q, True, every=1, **kw)
            log(f'{label} {how}: {len(seen)} rounds (ms, live lanes after) '
                'with the count read after every launch: '
                + ', '.join(f'({m:.4f}, {n})' for m, n in zip(per, seen)))
            res[how] = dict(ms=per, live=seen)
        ref = outs['shipped'][0]
        for v in runs:
            equal = all(torch.equal(a, b) for a, b in zip(outs[v][0], ref))
            res[v] = dict(whole_ms=statistics.median(whole[v]),
                          kernel_ms=statistics.median(ksum[v]),
                          whole_all=whole[v], kernel_all=ksum[v],
                          live_per_read=outs[v][1], equal=equal)
            log(f'{label} {v}: whole {res[v]["whole_ms"]:.3f} ms '
                f'({", ".join(f"{x:.3f}" for x in whole[v])}), kernels '
                f'{res[v]["kernel_ms"]:.3f} ms, equal to intersect_dda '
                f'{equal}; '
                f'live after each read {outs[v][1]}')
            if not equal:
                raise RuntimeError(f'{label} {v}: answers differ from '
                                   'intersect_dda\'s')
        record['queries'][label] = res
    log(card)
    print(json.dumps(record), flush=True)


if __name__ == '__main__':
    main()
