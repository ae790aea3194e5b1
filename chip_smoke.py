#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. the card (nvidia-smi name and power limit) and the kernel build, with
     every kernel's registers and local bytes (K2's and K3's on a line of
     their own);
  2. the bench city (``scene.synth.city_scene(width=1024, height=1024,
     depth=5, textured=True)``) built on the card, and the table its K2 and
     K3 walk (``scene.st_wide``, ``wide_bvh.pack_wide_stream``): its bytes,
     its host seconds (built again from the scene's contract tables) and
     its two stack needs;
  3. each CUDA kernel against its plain torch version on the queries of the
     render's first bounce, all 1,048,576 lanes each: the camera rays'
     nearest hit (K3, K2), the sorted shadow rays' any-hit (K2) and the
     sorted first-bounce rays' nearest hit (K3, K2); the march-vs-walk trace
     parity on the camera rays, and the count of unresolved march lanes (0);
     each query's times, its counted box tests, triangle tests and grid
     cells per ray and the bound they set.  K2's and K3's Woop test rounds
     as the plain version's, so no lane may settle an equal-t tie on
     another triangle than the plain version;
  4. ``render.render`` at 16 spp through both kernels, with launch counts,
     a finite image, and PSNR / mean against tests/goldens/city_bench_128.npz;
  5. the textured box (``scene.synth.box_scene(1024, 768, depth=6,
     textured=True)``) through the megakernel (K1): both entry points against
     the plain version on all 786,432 lanes (RNG, flags and counts equal and
     f32 rows within 1e-6 on every lane), each timed with its counted Woop
     tests, child-box tests and shades and the bound they set, then
     ``render.render`` at 64 spp with the fixed chain and with ``regen``,
     each with its launch count (and 0 launches of every other kernel), 0
     non-finite lane samples and PSNR >= 35 dB / mean within 2% against
     tests/goldens/box_1024x768_128.npz, and regen against the fixed chain;
  5b. the same box with each of its five walls cut into a 20 x 20 grid
     (``wall_subdiv=20``: 4,006 triangles, routed to K1 by ``'auto'``): the
     same checks, the lanes held against the plain version on the first
     TESS_LANES lanes (its brute trace over 4,096 rows is slow at full
     width), the times and counts at full width, both renders against the
     same golden;
  6. the instanced city (``scene.synth.instanced_city_scene(n_blocks=32,
     subdiv=3, ground_subdiv=32, width=1024, height=1024, depth=5,
     accel='stream_tlas')``) through the two-level kernel (K4): the kernel
     against its plain version on the camera rays' nearest hit, bounce 0's
     shadow any-hit and the Morton-sorted first-bounce rays' nearest hit,
     all 1,048,576 lanes each (hit flags and instance ids, t where the
     triangle is the same, equal-t pairs counted), each query with its
     time, its counted child-box tests, triangle tests and instance entries
     per ray and the bound they set; ``render.render`` at 16
     spp; the same city flattened (``accel='stream'``, K2/K3) at 16 spp with
     the same seeds: PSNR >= 35 dB, means within 2%, the share of pixels
     equal to 1e-3, the device memory of both builds (the contract tables
     and the kernel's wide tables apart); and the 48-block
     instanced city built under ``accel='auto'`` (must go two-level);
  7. the mid-size city (``scene.synth.city_scene(n_blocks=40, width=1024,
     height=1024, depth=5, textured=True)``, 152,194 triangles, routed to
     the cluster kernel K5 by ``'auto'``): the kernel against its plain
     version on the same three queries (unsorted), each with its time,
     counts per ray and bound; under any-hit the kernel reports the first
     occluder its walk meets and the plain version the lowest, so the
     reported triangle is tested against its lane's ray with the plain
     Moller-Trumbore arithmetic and must be valid on every occluded lane;
     ``render.render`` at 16 spp, and the same scene streamed at 16 spp:
     PSNR >= 35 dB, means within 2%;
  8. the cell-pass wavefront (K6): ``intersect_dda`` on the bench city's
     camera and sorted first-bounce rays (nearest) and on bounce 0's shadow
     rays (any-hit), over a grid without outliers and ``scene.st_wide``
     (each cluster of a lane's cell walked through its subtree, the round's
     stepping in the kernel): every lane must equal phase 3's dense plain
     answers (t, tri, u, v; any-hit: the hit flags) and no lane may be left
     live; rounds, the launches' summed device time (the same rounds
     launched through the wrapper, each behind a short spin on the card so
     that the host's time to submit it is not counted), the whole query's
     time, K6's registers and local bytes, its counted tests and cells per
     ray and the bound they set (each table it reads once: the grid's cell_tab, cell_cl
     and cl_aabb, st_wide's nodes, rows, index and cl_root), with the lane
     state a round reads and writes printed beside it.  No renderer path
     calls ``intersect_dda``, so this query is its main path: its launches
     are counted here;
  9. the textured box and the bench city as Hydra XML libraries: each
     description written by ``api.write_library`` into a temporary
     directory, loaded by ``scene.build.load_scene``, every table held
     against ``build_scene`` of the same description (integers exactly,
     floats to rtol 1e-6, the wide tables too); the loaded box rendered
     through K1 at 64 spp (fixed chain and ``regen``) and the loaded city
     through K2/K3 at 16 spp with the seeds of phases 5 and 4: launches,
     0 non-finite lane samples, each image's max abs difference from its
     phase's image, PSNR >= 35 dB and mean within 2% against the goldens;
     the library's bytes on disk and ``load_scene``'s host seconds for the
     city beside the card's name and power limit.
Every kernel's ``bound_ms`` is the larger of its bytes (rays and outputs
once, each table once) over 3.35 TB/s and its operations over 67 TFLOP/s
(f32 outside the tensor cores); the ray-query kernels' operations are
counted by a second build of csrc/traverse.cu (``-DHC3_COUNT``, loaded by
this script alone) run on the very query that is timed: what this kernel's
own walk did, not the least a query needs
(child-box tests x 25, Woop tests x 45 or Moller-Trumbore tests x 52, instance
entries x 36, grid cells x 20 operations); K1's by a second build of
csrc/megakernel.cu (``-DHC3_COUNT``, likewise) on the timed pass and launch
(Woop tests x 45, child-box tests x 25, shades x SHADE_OPS; K1 is built
without FMA contraction, so its attainable rate is half of 67 TFLOP/s,
which its line also prints; the bound keeps the table's convention).  No
single PyTorch call computes a ray query or a path-traced sample, so
``library_ms`` is null throughout.  The kernel sources (csrc/traverse.cu
with csrc/traverse_wide.cuh, which holds K2-K5, csrc/megakernel.cu, and
the counting build of each) build in parallel in phase 1;
nothing of an earlier phase was cut.  The line before the last is a JSON record of the kernels;
the last line is ``{"ok": true, "device": {...}}``.  Needs no JAX and no
network.
"""
import concurrent.futures
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
AGREE_MIN = 0.999
UV_TOL = 1e-4
PSNR_MIN = 35.0
MEAN_TOL = 0.02
REGEN_PSNR_MIN = 30.0
BOX_SPP = 64
# the card's published peaks: HBM bytes/s, f32 FLOP/s outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# f32 operations of one test, as the kernels write them (adds, multiplies,
# divides, min/max and compares each count one)
SLAB_OPS = 25      # 6 sub, 6 mul, 12 min/max, 1 compare
WOOP_OPS = 45      # 3 affine rows x (3 mul + 3 add) + 3 x (3 mul + 2 add),
#                    1 div, 1 neg, 2 x (mul + add), u + v, 5 compares
MT_OPS = 52        # 2 cross products, 4 dot products, 1 div, 3 sub,
#                    3 scalings, 7 compares
XFORM_OPS = 36     # ray into object space: 18 mul, 15 add, 3 div
CELL_OPS = 20      # cell exit planes and the step
# f32 operations of one K1 shade, reckoned once from csrc/megakernel.cu (each
# add, multiply, divide, compare, min/max, sqrt, rsqrt, sin and cos one): the
# hit's shade-row lerp, normal and flags (~75), the slot-0 texture tap
# (~85), NEE's light sample, shadow-ray set-up, GLTF eval and MIS weight
# (~450), the GLTF sample with its GGX sample and evals and the next ray
# (~480).  A light hit does less; every shade is counted at this figure.
SHADE_OPS = 1100
# lanes of the tessellated box held against the plain version (its brute
# trace over 4,096 rows is slow at full width); timing stays at full width
TESS_LANES = 65536


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call, by CUDA events after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(result, milliseconds) of one call, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved, ops):
    """(bound_ms, bound_by): the larger of bytes over the card's memory rate
    and operations over its f32 rate."""
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


@contextlib.contextmanager
def counted(TST, count_lib):
    """Inside the block the ray-query wrappers launch the counting build of
    csrc/traverse.cu (``-DHC3_COUNT``) in place of the shipped one; the
    list the block is given then receives what the lanes did in it: box
    tests, triangle tests, instances entered, grid cells visited."""
    shipped = TST.kernel_library()
    out = []
    TST.launch_checked('hc3_counts_reset', count_lib.hc3_counts_reset())
    TST._lib = count_lib
    try:
        yield out
    finally:
        TST._lib = shipped
    torch.cuda.synchronize()
    buf = (ctypes.c_uint64 * 4)()
    TST.launch_checked('hc3_counts_read', count_lib.hc3_counts_read(buf))
    out.extend(int(c) for c in buf)


def ray_query_bound(counts, n_rays, out_words, tables, tri_ops=WOOP_OPS):
    """Bound of one ray query: rays (32 bytes) and outputs once, each table
    once; the operations its counted launch reported."""
    slab, tri, inst, cell = counts
    ops = (slab * SLAB_OPS + tri * tri_ops + inst * XFORM_OPS
           + cell * CELL_OPS)
    moved = round(n_rays * (32 + 4 * out_words)) + nbytes(*tables)
    ms, by = bound(moved, ops)
    return ms, by, dict(box_tests=slab, tri_tests=tri, instances=inst,
                        cells=cell, bytes=moved, operations=ops)


# checks that fail the run only once every phase has run, so that one run
# shows every such lane (the equal-t ties)
DEFERRED = []


def compare(name, kernel, plain, any_hit=False, query=None, explain=None):
    """Kernel vs plain on every lane (``traverse_stream.hits_agree``): the
    hit flags and, where both hit, t to rtol 2e-4 must agree on AGREE_MIN
    of the lanes, the triangle on AGREE_MIN of the both-hit lanes, and the
    barycentrics u and v to UV_TOL on every lane where both report the
    same triangle.  With the ``query`` (pos, dir, t_min, t_max) given (the
    kernels whose Woop test rounds as the plain version's: K2, K3) no
    both-hit lane may report another triangle at an equal t: each such lane
    is printed, its ray in hex and what ``explain(lane)`` says of it, and
    fails the run at its end.  Returns max |dt| over the lanes with the
    same triangle."""
    from hydracore3_torch.accel.traverse_stream import hits_agree
    a = hits_agree(kernel, plain, any_hit)
    agree = a['hit_eq'] * a['t_ok']
    hits = int((kernel[1] >= 0).sum())
    log(f'  {name}: hits {hits}/{kernel[1].numel()} agree {agree:.6f} '
        f'tri-equal {a["tri_eq"]:.6f} max|dt| {a["max_dt"]:.3e} '
        f'max|du|,|dv| {a["max_duv"]:.3e}; lanes with another hit flag '
        f'{a["hit_diff"]}, both-hit lanes with another triangle '
        f'{a["tri_diff"]} ({a["tie_diff"]} at equal t)')
    if agree < AGREE_MIN or a['tri_eq'] < AGREE_MIN:
        raise RuntimeError(f'{name}: kernel and plain agree on {agree:.6f} '
                           f'of lanes and on the triangle of '
                           f'{a["tri_eq"]:.6f} of hits < {AGREE_MIN}')
    if a['max_duv'] > UV_TOL:
        raise RuntimeError(f'{name}: u, v off by {a["max_duv"]:.3e} > '
                           f'{UV_TOL} on a lane with the same triangle')
    if query is not None and a['tie_diff']:
        kt, ktri, pt, ptri = kernel[0], kernel[1], plain[0], plain[1]
        tie = torch.nonzero((ktri >= 0) & (ptri >= 0) & (ktri != ptri)
                            & (kt == pt)).squeeze(1).tolist()
        for i in tie[:8]:
            hexes = [float(x).hex() for x in (*query[0][i], *query[1][i],
                                               query[2][i], query[3][i])]
            log(f'    equal-t lane {i}: kernel tri {int(ktri[i])}, plain tri '
                f'{int(ptri[i])}, t {float(kt[i])!r}; pos, dir, t_min, '
                f't_max {" ".join(hexes)}'
                + (f'; {explain(i)}' if explain else ''))
        DEFERRED.append(f'{name}: {a["tie_diff"]} lanes settle an equal-t '
                        'tie on another triangle')
    return a['max_dt']


def psnr_mean(img, gold):
    """PSNR and relative mean error of img's RGB, box-downsampled to gold's
    size."""
    h, w = gold.shape[:2]
    k = img.shape[0] // h
    ds = img[..., :3].astype(np.float32).reshape(h, k, w, k, 3).mean((1, 3))
    mse = float(np.mean((ds - gold) ** 2))
    peak = max(float(gold.max()), 1e-9)
    return (10.0 * np.log10(peak * peak / max(mse, 1e-20)),
            abs(float(ds.mean()) / float(gold.mean()) - 1.0))


def compare_lanes(name, kernel, plain, exact_rows):
    """K1 against its plain version on every lane: f32 rows within
    MK.KERNEL_TOL and uint32 rows (RNG, flags, counts) equal."""
    from hydracore3_torch.models import megakernel as MK
    c, e, err = MK.lanes_agree(kernel, plain, exact_rows)
    log(f'  {name}: {kernel[0].shape[1]} lanes, close {c:.6f}, RNG/flags '
        f'equal {e:.6f}, max|d| {err:.3e}')
    if c < 1.0 or e < 1.0:
        raise RuntimeError(f'{name}: kernel and plain agree on {c:.6f} / '
                           f'{e:.6f} of lanes (1.0 required)')
    return err


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device (torch.cuda.is_available() is '
                 'False)')
    sys.path.insert(0, REPO)
    from hydracore3_torch import render as R
    from hydracore3_torch.accel import traverse_dda as TDD
    from hydracore3_torch.accel import traverse_pallas as TPL
    from hydracore3_torch.accel import traverse_stream as TST
    from hydracore3_torch.accel import traverse_tlas as TT
    from hydracore3_torch.accel import wide_bvh as WB
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.models import megakernel as MK
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth

    dev = torch.device('cuda:0')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and kernel build -----------------------------------------
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'python {sys.version.split()[0]}')
    # one nvcc per source, started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [pool.submit(f) for f in (
            TST.build_kernels, MK.build_kernels,
            lambda: TST.load_library(('HC3_COUNT',)),
            lambda: MK.load_library(('HC3_COUNT',)))]
        build_s = [b.result() for b in builds]
    count_lib, count_s = build_s[2]
    mega_count_lib, mega_count_s = build_s[3]
    log(f'[1] kernels built from hydracore3_torch/csrc/traverse.cu '
        f'({build_s[0]:.2f} s; its counting build {count_s:.2f} s) and '
        f'csrc/megakernel.cu ({build_s[1]:.2f} s; its counting build '
        f'{mega_count_s:.2f} s) in {time.perf_counter() - t0:.2f} s; K1 '
        f'{MK.kernel_attrs()}, of its counting build '
        f'{MK.kernel_attrs(mega_count_lib)}')
    attrs = TST.kernel_attrs()
    log(f'  registers, local bytes of K2-K6: {attrs}')
    log('  K2, K3: ' + ', '.join(
        f'{k} {attrs[k][0]} registers {attrs[k][1]} local bytes'
        for k in TST.KERNEL_NAMES[:3]))
    log(f'  of the counting build: {TST.kernel_attrs(count_lib)}')

    # ---- 2. the bench city on the card --------------------------------------
    t0 = time.perf_counter()
    scene, meta = synth.city_scene(width=1024, height=1024, depth=5,
                                   textured=True, device=dev)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    real = int((scene.st_woop.abs().sum(1) > 0).sum())
    g = scene.st_grid
    log(f'[2] city: {real} real triangles, meta.num_tris {meta.num_tris} '
        f'(padded), {scene.st_woop.shape[0] // TST.TBK} clusters, grid '
        f'{g.dims}, {g.n_outliers} outlier clusters, built in {host_s:.2f} s')
    if real != 215_554:
        raise RuntimeError(f'expected 215554 real triangles, got {real}')
    wide = scene.st_wide
    host = [getattr(scene, k).cpu().numpy() for k in (
        'st_nodes_f', 'st_nodes_i', 'st_woop', 'tri_v0', 'tri_e1', 'tri_e2')]
    t0 = time.perf_counter()
    again = WB.pack_wide_stream(*host)
    wide_s = time.perf_counter() - t0
    wide_tabs = tuple(wide.tensors().values())
    log(f'  st_wide (the K2/K3 table): {wide.nodes.shape[0]} wide nodes '
        f'({nbytes(wide.nodes)} B), {wide.rows.shape[0]} Woop rows '
        f'({nbytes(wide.rows)} B), index {nbytes(wide.index)} B, cl_root '
        f'{nbytes(wide.cl_root)} B: {nbytes(*wide_tabs) / 2**20:.2f} MiB on '
        f'the card beside the contract\'s {nbytes(scene.st_woop) / 2**20:.2f}'
        f' MiB of Woop rows; stack {wide.stack} (of {WB.MAX_STACK}), '
        f'cl_stack {wide.cl_stack} (of {WB.MARCH_STACK}), boxes widened by '
        f'{wide.margin:.3e}; built again from the contract tables on the '
        f'host in {wide_s:.2f} s')
    # (node records hold int32 references: compare bits, not floats)
    if not np.array_equal(again.nodes.view(np.int32),
                          wide.nodes.cpu().numpy().view(np.int32)) or \
            not np.array_equal(host[2][again.index], again.rows):
        raise RuntimeError('pack_wide_stream is not deterministic')
    del again, host

    # ---- 3. kernels against the plain version, at the main path's shapes --
    # The queries of the render's first bounce, built by the integrator's
    # own functions on all 1,048,576 pixels: the camera rays' nearest hit,
    # the shadow rays' any-hit in the order the pass traces them, and the
    # sorted first-bounce rays' nearest hit.
    N = meta.width * meta.height
    woop = scene.st_woop
    stream = lambda *q, **kw: TST.intersect_stream(  # noqa: E731
        scene.st_nodes_f, scene.st_nodes_i, woop, *q, wide=wide, **kw)
    march = lambda *q, **kw: TDD.intersect_march(  # noqa: E731
        scene.st_grid, woop, *q, with_unresolved=True, wide=wide, **kw)

    def query_counts(name, label, run, tables, tri_ops, n=N):
        """One counted launch of a query: its tests per ray and the bound
        they set; ``tables`` are what the kernel reads, and the outputs
        count at the size the kernel writes them (int64 indices)."""
        with counted(TST, count_lib) as c:
            out = run()
        b = ray_query_bound(c, n, nbytes(*out) / (4 * n), tables,
                            tri_ops=tri_ops)
        log(f'  {name} {label}: per ray {c[0] / n:.2f} child-box tests, '
            f'{c[1] / n:.2f} triangle tests, {c[2] / n:.3f} instance '
            f'entries, {c[3] / n:.3f} grid cells; bound {b[0]:.4f} ms by '
            f'{b[1]} {b[2]}')
        return b
    errs = {'intersect_stream': 0.0, 'intersect_march': 0.0}
    bounds = {}
    unresolved = 0

    def check_nearest(label, state):
        """K3 and K2 nearest against the plain version on a bounce's
        nearest-hit query (the arguments kernel_ray_trace passes)."""
        nonlocal unresolved
        live = ~IPT._is_dead(state.flags)
        q = (state.ray_pos, state.ray_dir, torch.zeros(N, device=dev),
             torch.where(live, IPT.LM.FLT_MAX, 0.0))
        plain, p_ms = timed(lambda: TST.intersect_plain(
            woop, *q[:3], torch.clamp(q[3], max=0.99 * TST.FLT_MAX)))
        *km, un = march(*q)
        unresolved += int(un.sum())
        def explain(i):
            """What the walk in plain torch (exact arithmetic) returns on
            lane i, and where its plain hit lies in grid-cell units."""
            w = WB.walk_wide_plain(wide, q[0][i:i + 1], q[1][i:i + 1],
                                   q[2][i:i + 1], torch.clamp(
                                       q[3][i:i + 1], max=TST.T_MAX_CAP))
            hit = q[0][i] + plain[0][i] * q[1][i]
            cells = [(float(hit[k]) - g.lo[k]) / g.h[k] for k in range(3)]
            return (f'walk_wide_plain tri {int(w[1][0])}; the hit at cell '
                    f'coordinates {[round(c, 6) for c in cells]}')

        errs['intersect_march'] = max(errs['intersect_march'], compare(
            f'K3 intersect_march nearest, {label}', km, plain, query=q,
            explain=explain))
        ks = stream(*q)
        errs['intersect_stream'] = max(errs['intersect_stream'], compare(
            f'K2 intersect_stream nearest, {label}', ks, plain, query=q,
            explain=explain))
        log(f'  {label}: {int(live.sum())} live rays; plain {p_ms:.3f} ms')
        return q, km, ks, p_ms, plain

    log(f'[3] kernels vs plain on the first bounce of the pass, {N} lanes')
    pix_all = torch.arange(N, device=dev)
    st = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix_all), pix_all)
    (cam_q, (mt, mtri, _, _), (wt, wtri, _, _), cam_plain_ms,
     cam_plain) = check_nearest('camera', st)

    # trace parity (bench.py:90-106): march against walk, all camera rays
    mh, wh = (mtri >= 0).cpu().numpy(), (wtri >= 0).cpu().numpy()
    both = mh & wh
    agree_t = np.isclose(mt.cpu().numpy()[both], wt.cpu().numpy()[both],
                         rtol=1e-3, atol=1e-4)
    parity = float((mh == wh).mean() * agree_t.mean())
    log(f'  trace_parity (march vs walk, {N} camera rays): {parity:.6f}')
    if parity < AGREE_MIN:
        raise RuntimeError(f'trace_parity {parity:.6f} < {AGREE_MIN}')

    # the shadow query of bounce 0, as shadow_occluded sends it to K2
    st = IPT.kernel_ray_trace(scene, meta, st, 0)
    ctx = IPT.MAT.make_shading_ctx(scene, meta, IPT._extract_mat_id(st.flags),
                                   st.hit_norm, st.hit_tang, st.hit_uv)
    _, _, _, rays = IPT.sample_shadow_rays(scene, meta, st)
    _, *shadow_q = IPT.sorted_shadow_query(scene.st_grid, rays)
    shadow_plain, shadow_plain_ms = timed(lambda: TST.intersect_plain(
        woop, *shadow_q[:3], torch.clamp(shadow_q[3], max=0.99 * TST.FLT_MAX),
        any_hit=True))
    errs['intersect_stream'] = max(errs['intersect_stream'], compare(
        'K2 intersect_stream any-hit, shadow', stream(*shadow_q, any_hit=True),
        shadow_plain, any_hit=True, query=shadow_q))
    log(f'  shadow: {int(rays.need_trace.sum())} traced rays, '
        f'{int((shadow_plain[1] >= 0).sum())} occluded; plain '
        f'{shadow_plain_ms:.3f} ms')

    # the first-bounce rays, sorted as trace_pass sorts them for bounce 1
    shade, rng2 = IPT.kernel_sample_light_source(scene, meta, st, ctx)
    st = IPT.kernel_next_bounce(scene, meta, st._replace(rng=rng2), 0, shade,
                                ctx)
    st, _ = IPT._sort_rays_for_trace(st, pix_all, scene.st_grid)
    bounce_q, _, _, bounce_plain_ms, bounce_plain = check_nearest('bounce',
                                                                  st)
    log(f'  unresolved march lanes: {unresolved}')
    if unresolved:
        raise RuntimeError(f'{unresolved} march lanes left unresolved')

    # kernel times at the same shapes (CUDA events, 10 calls after a warm-up)
    ms = {'intersect_stream': cuda_ms(
              lambda: stream(*shadow_q, any_hit=True), 10),
          'intersect_march': cuda_ms(lambda: march(*cam_q), 10)}
    plain_ms = {'intersect_stream': shadow_plain_ms,
                'intersect_march': cam_plain_ms}
    log(f'  K2 any-hit, shadow: {ms["intersect_stream"]:.3f} ms; plain '
        f'{shadow_plain_ms:.3f} ms')
    log(f'  K3 nearest, camera: {ms["intersect_march"]:.3f} ms; plain '
        f'{cam_plain_ms:.3f} ms')
    log(f'  K3 nearest, bounce: {cuda_ms(lambda: march(*bounce_q), 10):.3f} '
        f'ms; plain {bounce_plain_ms:.3f} ms')
    for label, q in (('camera', cam_q), ('bounce', bounce_q)):
        log(f'  K2 nearest, {label}: {cuda_ms(lambda: stream(*q), 10):.3f} '
            f'ms')
    # what each query's walk did, and the bounds it sets; the table rows
    # carry the two timed queries' (K2's reads st_wide's nodes, rows and
    # index; K3's the grid and all of st_wide)
    g = scene.st_grid
    k2_tabs = (wide.nodes, wide.rows, wide.index)
    k3_tabs = (g.cell_tab, g.cell_cl, g.cl_aabb, g.outliers) + wide_tabs
    bounds['intersect_stream'] = query_counts(
        'intersect_stream', 'any-hit, shadow',
        lambda: stream(*shadow_q, any_hit=True), k2_tabs, WOOP_OPS)
    for label, q in (('nearest, camera', cam_q), ('nearest, bounce',
                                                  bounce_q)):
        query_counts('intersect_stream', label, lambda: stream(*q), k2_tabs,
                     WOOP_OPS)
    bounds['intersect_march'] = query_counts(
        'intersect_march', 'camera', lambda: march(*cam_q), k3_tabs,
        WOOP_OPS)
    query_counts('intersect_march', 'bounce', lambda: march(*bounce_q),
                 k3_tabs, WOOP_OPS)

    # ---- 4. the slice: render.render at 16 spp ------------------------------
    spp = 16
    TST.intersect_stream.launches = 0
    TDD.intersect_march.launches = 0
    img, timing = R.render(scene, meta, spp=spp, integrator='mispt',
                           tile_size=1 << 20, return_timing=True)
    launches = {'intersect_stream': TST.intersect_stream.launches,
                'intersect_march': TDD.intersect_march.launches}
    msps = N * spp / timing['total_s'] / 1e6
    # one march and one shadow any-hit per bounce; K2's launches beyond the
    # march's re-traced unresolved lanes
    log(f'[4] render {meta.width}x{meta.height} spp {spp}: '
        f'{timing["total_s"]:.2f} s, {msps:.4f} Msamples/s, launches '
        f'{launches} (K2 fallback launches '
        f'{launches["intersect_stream"] - launches["intersect_march"]}), '
        f'non-finite lane samples {timing["nonfinite"]}')
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f'{name} was not launched by the main path')
    if not np.isfinite(img).all():
        raise RuntimeError('render produced non-finite pixels')
    gold = np.load(os.path.join(REPO, 'tests', 'goldens',
                                'city_bench_128.npz'))['img'].astype(np.float32)
    city_img = img
    psnr, mean_rel = psnr_mean(img, gold)
    log(f'  PSNR vs golden {psnr:.2f} dB; mean {100 * mean_rel:.3f}% off')
    if psnr < PSNR_MIN or mean_rel > MEAN_TOL:
        raise RuntimeError(f'image off the golden: PSNR {psnr:.2f} dB, mean '
                           f'{100 * mean_rel:.3f}% off')

    # ---- 5. the box through the megakernel (K1); 5b. the tessellated box --
    gold_box = np.load(os.path.join(REPO, 'tests', 'goldens',
                                    'box_1024x768_128.npz'))['img']

    def k1_counted(run):
        """What one K1 launch's lanes did, by the counting build of
        csrc/megakernel.cu (-DHC3_COUNT): Woop tests, child-box tests,
        shades."""
        shipped = MK._lib
        TST.launch_checked('hc3_mega_counts_reset',
                           mega_count_lib.hc3_mega_counts_reset())
        MK._lib = mega_count_lib
        try:
            run()
        finally:
            MK._lib = shipped
        torch.cuda.synchronize()
        buf = (ctypes.c_uint64 * 3)()
        TST.launch_checked('hc3_mega_counts_read',
                           mega_count_lib.hc3_mega_counts_read(buf))
        return [int(c) for c in buf]

    def megakernel_phase(tag, sc, mt, n_cmp):
        """K1 on one small scene: both entry points against the plain
        version on the first ``n_cmp`` lanes (all of them when n_cmp is
        None), timed at full width with complete bounds, then both renders
        at BOX_SPP against the box golden (>= 35 dB, mean within 2%) with
        the counts at 0 just before each, and regen against the fixed
        chain.  Returns {name: (ms, plain_ms, bound, err, launches)}."""
        pk = MK.pack(sc, mt)
        xy, su = MK.lane_setup(mt, dev)
        depth, it, n = mt.trace_depth, MK.REGEN_ITERS, xy.shape[1]
        w = pk.wide
        log(f'[{tag}] {mt.width}x{mt.height}: {mt.num_tris} triangles '
            f'({pk.n_tris} padded rows), {mt.num_lights} lights, depth '
            f'{depth}, {n} lanes; supported {MK.supported(sc, mt)}; '
            f'use_stream {mt.use_stream}, use_pallas {mt.use_pallas}; the '
            f'wide table: '
            f'{w.nodes.shape[0]} nodes, stack {w.stack} (of '
            f'{MK.MEGA_STACK}), {nbytes(*w.tensors().values())} B')
        if mt.use_stream or mt.use_pallas or mt.use_stream_tlas \
                or not MK.supported(sc, mt):
            raise RuntimeError(f'{tag}: accel=auto did not route to K1')
        m = n if n_cmp is None else n_cmp
        xs, ss = xy[:, :m].contiguous(), su[:, :m].contiguous()
        out = {}
        k_fixed = MK.sample_pass(pk, xs, ss, depth)
        p_fixed, p_ms = timed(lambda: MK.sample_pass_plain(pk, xs, ss,
                                                           depth))
        err_f = compare_lanes(f'K1 mega_sample_kernel (fixed chain), {tag}',
                              k_fixed, p_fixed, 3)
        sf, su_r = MK.regen_pass(pk, xs, None, ss, it, depth, first=True)
        k_regen = MK.regen_pass(pk, xs, sf, su_r, it, depth)
        sf_p, su_p = MK.regen_iters_plain(pk, xs, None, ss, it, depth,
                                          first=True)
        p_regen, p_ms_r = timed(lambda: MK.regen_iters_plain(
            pk, xs, sf_p, su_p, it, depth))
        err_r = compare_lanes(
            f'K1 mega_regen_kernel ({it} iterations after rfirst + '
            f'{it - 1}), {tag}', k_regen, p_regen, MK.RU_NROWS)
        del k_fixed, p_fixed, k_regen, p_regen, sf_p, su_p
        # full width: times, and the counted launch behind each bound
        # (lane state in and out, each table once; Woop tests x 45 +
        # child-box tests x 25 + shades x SHADE_OPS)
        sf, su_r = MK.regen_pass(pk, xy, None, su, it, depth, first=True)
        tables = (w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light,
                  pk.tex, pk.consts, pk.texels)
        for name, run, io, pms, err in (
                ('mega_sample', lambda: MK.sample_pass(pk, xy, su, depth),
                 64 * n, p_ms, err_f),
                ('mega_regen',
                 lambda: MK.regen_pass(pk, xy, sf, su_r, it, depth),
                 328 * n, p_ms_r, err_r)):
            k_ms = cuda_ms(run, 10)
            unit = ('pass' if name == 'mega_sample' else
                    f'{it}-iteration launch')
            woop_t, slab_t, shades = k1_counted(run)
            ops = woop_t * WOOP_OPS + slab_t * SLAB_OPS + shades * SHADE_OPS
            b = bound(io + nbytes(*tables), ops)
            log(f'  {name}, {tag}: {k_ms:.3f} ms per {unit} at {n} lanes; '
                f'plain {pms:.3f} ms ({m} lanes); per lane '
                f'{woop_t / n:.3f} Woop tests, {slab_t / n:.3f} child-box '
                f'tests, {shades / n:.3f} shades; bound {b[0]:.4f} ms by '
                f'{b[1]} (operations {ops}, bytes {io + nbytes(*tables)}; '
                f'{k_ms / b[0]:.1f}x above; at the no-FMA rate of half '
                f'{PEAK_F32_OPS_S / 1e12:.0f} TFLOP/s the operations take '
                f'{2 * ops / PEAK_F32_OPS_S * 1e3:.4f} ms)')
            out[name] = [k_ms, pms, b, err, 0]
        imgs = {}
        for name, regen in (('mega_sample', False), ('mega_regen', True)):
            zero_counts()
            img, timing = R.render(sc, mt, spp=BOX_SPP, regen=regen,
                                   return_timing=True)
            n_l = (MK.regen_pass if regen else MK.sample_pass).launches
            others = {w_.__name__: w_.launches for w_ in counters
                      if w_ not in (MK.sample_pass, MK.regen_pass)}
            out[name][4] = n_l
            samples = timing.get('samples', mt.width * mt.height * BOX_SPP)
            p, mean_rel = psnr_mean(img, gold_box)
            log(f'  render {"regen" if regen else "fixed"} {BOX_SPP} spp, '
                f'{tag}: {timing["total_s"]:.3f} s, '
                f'{samples / timing["total_s"] / 1e6:.2f} Msamples/s '
                f'({samples} samples), launches {n_l} (other kernels '
                f'{others}), non-finite lane samples {timing["nonfinite"]}; '
                f'vs golden PSNR {p:.2f} dB, mean {100 * mean_rel:.3f}% off')
            if n_l == 0 or any(others.values()):
                raise RuntimeError(f'{tag} {name}: K1 launches {n_l}, other '
                                   f'kernels {others}')
            if timing['nonfinite'] or not np.isfinite(img).all():
                raise RuntimeError(f'{tag} {name}: non-finite samples')
            if p < PSNR_MIN or mean_rel > MEAN_TOL:
                raise RuntimeError(f'{tag} {name} off the golden: PSNR '
                                   f'{p:.2f} dB, mean {100 * mean_rel:.3f}% '
                                   'off')
            imgs[name] = img[..., :3]
        p_rf, _ = psnr_mean(imgs['mega_regen'], imgs['mega_sample'])
        log(f'  regen vs fixed chain, {tag}: PSNR {p_rf:.2f} dB')
        if p_rf < REGEN_PSNR_MIN:
            raise RuntimeError(f'{tag}: regen vs fixed {p_rf:.2f} dB < '
                               f'{REGEN_PSNR_MIN}')
        return out, imgs

    counters = (TST.intersect_stream, TDD.intersect_march, TDD.cell_pass,
                TT.intersect_stream_tlas, TPL.intersect_clusters,
                MK.sample_pass, MK.regen_pass)

    def zero_counts():
        for w_ in counters:
            w_.launches = 0

    box, bmeta = synth.box_scene(1024, 768, depth=6, textured=True,
                                 device=dev)
    k1, box_imgs = megakernel_phase('5', box, bmeta, None)
    del box
    tess, tmeta = synth.box_scene(1024, 768, depth=6, textured=True,
                                  wall_subdiv=20, device=dev)
    k1_tess, _ = megakernel_phase('5b', tess, tmeta, TESS_LANES)
    del tess
    for name in ('mega_sample', 'mega_regen'):
        ms[name], plain_ms[name], bounds[name], errs[name], \
            launches[name] = k1[name]
        errs[name] = max(errs[name], k1_tess[name][3])

    def first_bounce_queries(sc, mt):
        """The pass's first-bounce queries as ``trace_pass`` sends them:
        (camera nearest, bounce-0 shadow any-hit, first-bounce nearest),
        each (pos, dir, t_min, t_max), and the count of traced shadow
        rays."""
        n = mt.width * mt.height
        pix = torch.arange(n, device=dev)
        zeros = torch.zeros(n, device=dev)
        stt = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix)

        def nearest_q(state):
            live_ = ~IPT._is_dead(state.flags)
            return (state.ray_pos, state.ray_dir, zeros,
                    torch.where(live_, IPT.LM.FLT_MAX, 0.0))

        cam = nearest_q(stt)
        stt = IPT.kernel_ray_trace(sc, mt, stt, 0)
        cx = IPT.MAT.make_shading_ctx(sc, mt, IPT._extract_mat_id(stt.flags),
                                      stt.hit_norm, stt.hit_tang, stt.hit_uv)
        _, _, _, sr = IPT.sample_shadow_rays(sc, mt, stt)
        shadow = (sr.pos, sr.dir, zeros, sr.t_max)    # lane order
        sh, r2 = IPT.kernel_sample_light_source(sc, mt, stt, cx)
        stt = IPT.kernel_next_bounce(sc, mt, stt._replace(rng=r2), 0, sh, cx)
        if mt.use_stream or mt.use_stream_tlas:
            stt, _ = IPT._sort_rays_for_trace(stt, pix, sc.st_grid)
        return cam, shadow, nearest_q(stt), int(sr.need_trace.sum())

    def render_checked(label, sc, mt, wrapper, spp_=16):
        """``render.render`` with the counts at 0 just before; returns
        (image, launches of ``wrapper``, Msamples/s)."""
        zero_counts()
        im, tm = R.render(sc, mt, spp=spp_, integrator='mispt',
                          tile_size=1 << 20, return_timing=True)
        n_l = wrapper.launches
        rate = mt.width * mt.height * spp_ / tm['total_s'] / 1e6
        log(f'  render {label} {mt.width}x{mt.height} spp {spp_}: '
            f'{tm["total_s"]:.2f} s, {rate:.4f} Msamples/s, '
            f'{wrapper.__name__} launches {n_l}, non-finite lane samples '
            f'{tm["nonfinite"]}')
        if n_l == 0:
            raise RuntimeError(f'{wrapper.__name__} was not launched by '
                               f'{label}')
        if tm['nonfinite'] or not np.isfinite(im).all():
            raise RuntimeError(f'{label}: non-finite samples')
        return im, n_l, rate

    def same_image(label, im, ref):
        """Two full-size renders of one scene with the same seeds."""
        p_, m_ = psnr_mean(im, ref[..., :3])
        same = float(np.isclose(im[..., :3], ref[..., :3], rtol=1e-3,
                                atol=1e-3).all(-1).mean())
        log(f'  {label}: PSNR {p_:.2f} dB, mean {100 * m_:.3f}% off, '
            f'{same:.6f} of pixels equal to 1e-3')
        if p_ < PSNR_MIN or m_ > MEAN_TOL:
            raise RuntimeError(f'{label}: PSNR {p_:.2f} dB, mean '
                               f'{100 * m_:.3f}% off')

    # ---- 6. the instanced city through the two-level kernel (K4) ---------
    ICITY = dict(n_blocks=32, subdiv=3, ground_subdiv=32, width=1024,
                 height=1024, depth=5)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    tl_scene, tl_meta = synth.instanced_city_scene(**ICITY,
                                                   accel='stream_tlas',
                                                   device=dev)
    torch.cuda.synchronize()
    tl_build_s = time.perf_counter() - t0
    tl_mem = torch.cuda.memory_allocated() - mem0
    pack = tl_scene.tt
    wide6 = tuple(pack.wide.tensors().values())
    log(f'[6] instanced city: {tl_meta.num_tris} soup triangles as '
        f'{pack.inst_f.shape[0]} instances of {pack.mesh_clusters.shape[0]} '
        f'meshes, {pack.woop.shape[0] // TST.TBK} clusters, '
        f'{pack.tlas_f.shape[0]} TLAS nodes, {pack.nodes_f.shape[0]} mesh '
        f'nodes; the kernel\'s tables: {pack.wide.nodes.shape[0]} wide nodes, '
        f'{pack.wide.rows.shape[0]} triangle rows, stack {pack.wide.stack}; '
        f'built in {tl_build_s:.2f} s, {tl_mem / 2**20:.2f} MiB on the card '
        f'(contract tables '
        f'{nbytes(*(getattr(pack, k) for k in TT._TABLES)) / 2**20:.2f} MiB, '
        f'the kernel\'s {nbytes(*wide6) / 2**20:.2f} MiB)')
    if not tl_meta.use_stream_tlas:
        raise RuntimeError('the instanced city was not built two-level')
    tlas = lambda *q, **kw: TT.intersect_stream_tlas(  # noqa: E731
        pack, *q, **kw)
    cam6, shadow6, bounce6, traced6 = first_bounce_queries(tl_scene, tl_meta)
    errs['intersect_tlas'] = 0.0
    for label, q, any_hit in (('camera nearest', cam6, False),
                              ('shadow any-hit', shadow6, True),
                              ('bounce nearest', bounce6, False)):
        plain6, p_ms = timed(lambda: TT.intersect_tlas_plain(
            pack, *q[:3], torch.clamp(q[3], max=0.99 * TST.FLT_MAX), any_hit))
        k6 = tlas(*q, any_hit=any_hit)
        errs['intersect_tlas'] = max(errs['intersect_tlas'], compare(
            f'K4 intersect_tlas {label}', k6, plain6, any_hit))
        both6 = (k6[1] >= 0) & (plain6[1] >= 0)
        inst_eq = float((k6[4] == plain6[4]).float().mean())
        ties = int((both6 & (k6[0] == plain6[0])
                    & ((k6[1] != plain6[1]) | (k6[4] != plain6[4]))).sum())
        k_ms = cuda_ms(lambda: tlas(*q, any_hit=any_hit), 10)
        log(f'  {label}: instance ids equal on {inst_eq:.6f} of lanes, '
            f'{ties} equal-t pairs with another triangle or instance; '
            f'kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms')
        if inst_eq < AGREE_MIN:
            raise RuntimeError(f'K4 {label}: instance ids equal on '
                               f'{inst_eq:.6f} < {AGREE_MIN}')
        b6 = query_counts('intersect_tlas', label,
                          lambda: tlas(*q, any_hit=any_hit), wide6,
                          WOOP_OPS)
        if label == 'camera nearest':
            ms['intersect_tlas'], plain_ms['intersect_tlas'] = k_ms, p_ms
            bounds['intersect_tlas'] = b6
    log(f'  shadow: {traced6} traced rays')
    del plain6, k6, cam6, shadow6, bounce6
    tl_img, launches['intersect_tlas'], _ = render_checked(
        'two-level', tl_scene, tl_meta, TT.intersect_stream_tlas)
    del tl_scene, pack
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    flat_scene, flat_meta = synth.instanced_city_scene(**ICITY,
                                                       accel='stream',
                                                       device=dev)
    torch.cuda.synchronize()
    log(f'  the same city flattened: {flat_meta.num_tris} padded soup rows, '
        f'built in {time.perf_counter() - t0:.2f} s, '
        f'{(torch.cuda.memory_allocated() - mem0) / 2**20:.2f} MiB on the '
        f'card (two-level: {tl_mem / 2**20:.2f} MiB)')
    flat_img, _, _ = render_checked('flattened', flat_scene, flat_meta,
                                    TDD.intersect_march)
    same_image('two-level vs flattened', tl_img, flat_img)
    del flat_scene, tl_img, flat_img
    _, big_meta = B.build_scene(synth.build_instanced_city(
        n_blocks=48, width=1024, height=1024), device=dev)
    log(f'  48-block instanced city under accel=auto: {big_meta.num_tris} '
        f'soup triangles, use_stream_tlas {big_meta.use_stream_tlas}')
    if not big_meta.use_stream_tlas or big_meta.num_tris != 209_410:
        raise RuntimeError('the 48-block instanced city must go two-level')

    # ---- 7. the mid-size city through the cluster kernel (K5) ------------
    MID = dict(n_blocks=40, width=1024, height=1024, depth=5, textured=True)
    t0 = time.perf_counter()
    cl_scene, cl_meta = synth.city_scene(**MID, device=dev)
    torch.cuda.synchronize()
    wide7 = tuple(cl_scene.cl_wide.tensors().values())
    log(f'[7] mid-size city: {cl_meta.num_tris} triangles, '
        f'{cl_scene.cl_nodes_f.shape[0]} nodes, use_pallas '
        f'{cl_meta.use_pallas}; the kernel\'s tables: '
        f'{cl_scene.cl_wide.nodes.shape[0]} wide nodes, stack '
        f'{cl_scene.cl_wide.stack}, {nbytes(*wide7) / 2**20:.2f} MiB on the '
        f'card beside the contract\'s triangle rows, '
        f'{nbytes(cl_scene.cl_tris12) / 2**20:.2f} MiB (its node tables, '
        f'{nbytes(cl_scene.cl_nodes_f, cl_scene.cl_nodes_i) / 2**20:.2f} '
        f'MiB, stay on the host); built in {time.perf_counter() - t0:.2f} s')
    if not cl_meta.use_pallas or cl_meta.num_tris != 152_194:
        raise RuntimeError('the 40-block city must route to the cluster '
                           'kernel with 152194 triangles')
    clusters = lambda *q, **kw: TPL.intersect_clusters(  # noqa: E731
        cl_scene.cl_nodes_f, cl_scene.cl_nodes_i, cl_scene.cl_tris12, *q,
        wide=cl_scene.cl_wide, **kw)
    cam7, shadow7, bounce7, traced7 = first_bounce_queries(cl_scene, cl_meta)
    errs['intersect_clusters'] = 0.0
    for label, q, any_hit in (('camera nearest', cam7, False),
                              ('shadow any-hit', shadow7, True),
                              ('bounce nearest', bounce7, False)):
        plain7, p_ms = timed(lambda: TPL.intersect_clusters_plain(
            cl_scene.cl_tris12, *q, any_hit))
        k7 = clusters(*q, any_hit=any_hit)
        errs['intersect_clusters'] = max(errs['intersect_clusters'], compare(
            f'K5 intersect_clusters {label}', k7, plain7, any_hit))
        if any_hit:
            # the kernel reports the first occluder its walk meets, the
            # plain version the lowest: hold the reported one to its lane
            occ = k7[1] >= 0
            valid = TPL.occluder_valid(cl_scene.cl_tris12, k7[1], *q)
            log(f'  {label}: the reported triangle occludes its lane on '
                f'{int((valid & occ).sum())} of {int(occ.sum())} occluded '
                f'lanes; the same triangle as the plain version on '
                f'{float((k7[1] == plain7[1])[occ].float().mean()):.6f}')
            if not bool((valid == occ).all()):
                raise RuntimeError('K5 any-hit reported a triangle that '
                                   'does not occlude its lane')
        k_ms = cuda_ms(lambda: clusters(*q, any_hit=any_hit), 10)
        log(f'  {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms')
        b7 = query_counts('intersect_clusters', label,
                          lambda: clusters(*q, any_hit=any_hit), wide7,
                          MT_OPS)
        if label == 'camera nearest':
            ms['intersect_clusters'] = k_ms
            plain_ms['intersect_clusters'] = p_ms
            bounds['intersect_clusters'] = b7
    log(f'  shadow: {traced7} traced rays')
    del plain7, k7, cam7, shadow7, bounce7
    cl_img, launches['intersect_clusters'], _ = render_checked(
        'cluster route', cl_scene, cl_meta, TPL.intersect_clusters)
    del cl_scene
    st_scene, st_meta = synth.city_scene(**MID, accel='stream', device=dev)
    st_img, _, _ = render_checked('streamed', st_scene, st_meta,
                                  TDD.intersect_march)
    same_image('cluster route vs streamed', cl_img, st_img)
    del st_scene, cl_img, st_img

    # ---- 8. the cell-pass wavefront (K6) on the bench city ---------------
    grid0 = TDD.pack_grid(scene.st_nodes_f.cpu().numpy(),
                          scene.st_nodes_i.cpu().numpy(),
                          robust_aabb=False).to(dev)
    log(f'[8] intersect_dda on the bench city, grid {grid0.dims} without '
        f'outliers ({grid0.n_outliers}); cell_pass_kernel registers, local '
        f'bytes: nearest {attrs[TST.KERNEL_NAMES[7]]}, any-hit '
        f'{attrs[TST.KERNEL_NAMES[8]]}')
    dda = lambda *q, **kw: TDD.intersect_dda(  # noqa: E731
        grid0, None, *q, wide=wide, **kw)

    def check_dda(label, q, plain, any_hit=False):
        """K6 against the dense plain version on every lane: (t, tri, u, v)
        equal (any-hit: the hit flags), and no lane left live."""
        st8 = {}
        k = dda(*q, any_hit=any_hit, stats=st8)
        err = compare(f'K6 intersect_dda {label}', k, plain, any_hit)
        if any_hit:
            other = (k[1] >= 0) != (plain[1] >= 0)
        else:
            other = ~((k[0] == plain[0]) & (k[1] == plain[1])
                      & (k[2] == plain[2]) & (k[3] == plain[3]))
        lanes = torch.nonzero(other).squeeze(1).tolist()
        log(f'  {label}: {st8["rounds"]} launches, {st8["live"]} lanes left '
            f'live, the launches {st8["kernel_ms"]:.3f} ms in all; lanes '
            f'unlike the dense plain version: {len(lanes)}')
        for i in lanes[:8]:
            log(f'    lane {i}: K6 t {float(k[0][i])!r} tri {int(k[1][i])}, '
                f'plain t {float(plain[0][i])!r} tri {int(plain[1][i])}')
        if lanes:
            DEFERRED.append(f'K6 {label}: {len(lanes)} lanes unlike the '
                            'dense plain version')
        if st8['live']:
            raise RuntimeError(f'{st8["live"]} lanes left live by '
                               f'intersect_dda ({label})')
        return err

    errs['cell_pass'] = max(
        check_dda('nearest, camera', cam_q, cam_plain),
        check_dda('nearest, sorted first bounce', bounce_q, bounce_plain),
        check_dda('any-hit, shadow', shadow_q, shadow_plain, any_hit=True))
    # its main path is the entry point itself: one nearest camera query
    # with the counts at 0 just before, timed as a whole; then the
    # launches' summed time (CUDA events around each launch) on another
    zero_counts()
    k_cam, total_ms = timed(lambda: dda(*cam_q))
    launches['cell_pass'] = TDD.cell_pass.launches
    if launches['cell_pass'] == 0:
        raise RuntimeError('cell_pass was not launched by intersect_dda')
    stats = {}
    dda(*cam_q, stats=stats)
    # the launches' device time: the same rounds through the wrapper, each
    # queued behind a ~0.1 ms spin on the card, so that the card's wait for
    # the host to submit a launch (which intersect_dda's own events count
    # between short launches) is not counted as the kernel's
    rays8 = TST.ray_arrays('chip_smoke', *cam_q)
    state8 = TDD.empty_state(rays8[0].shape[0], dev)
    counts8 = torch.zeros(stats['rounds'], dtype=torch.int32, device=dev)
    pairs = []
    for r in range(stats['rounds']):
        torch.cuda._sleep(200_000)
        pairs.append((torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)))
        pairs[-1][0].record()
        TDD.cell_pass(grid0, wide, rays8, state8, counts8[r:r + 1],
                      first=r == 0)
        pairs[-1][1].record()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(state8[3:], k_cam)):
        raise RuntimeError('cell_pass launched round by round answers '
                           'otherwise than intersect_dda')
    ms['cell_pass'] = sum(a.elapsed_time(b) for a, b in pairs)
    plain_ms['cell_pass'] = cam_plain_ms
    log(f'  nearest, camera: {total_ms:.3f} ms for the whole query, '
        f'{launches["cell_pass"]} launches (the count of live lanes read '
        f'after every {TDD.READ_EVERY}th); the launches '
        f'{ms["cell_pass"]:.3f} ms in all on the card '
        f'({ms["cell_pass"] / stats["rounds"]:.4f} ms a launch; '
        f'{stats["kernel_ms"]:.3f} ms as intersect_dda\'s events count '
        f'them, with the card\'s waits for the host); dense plain '
        f'{cam_plain_ms:.3f} ms')
    k6_tabs = (grid0.cell_tab, grid0.cell_cl, grid0.cl_aabb, wide.nodes,
               wide.rows, wide.index, wide.cl_root)
    bounds['cell_pass'] = query_counts('cell_pass', 'nearest, camera',
                                       lambda: dda(*cam_q), k6_tabs,
                                       WOOP_OPS)
    query_counts('cell_pass', 'nearest, sorted first bounce',
                 lambda: dda(*bounce_q), k6_tabs, WOOP_OPS)
    # the lane state the rounds read and write: a live lane reads its ray
    # (32 B) and reads and writes its state (cell 12, t_cur 4, done 4, best
    # 20 B) once a lane-round, which the counted cells are; every launch
    # reads the done flag (4 B) of each lane already retired
    lane_round = 32 + 2 * 40
    cells = bounds['cell_pass'][2]['cells']
    flags = (launches['cell_pass'] * cam_q[0].shape[0] - cells) * 4
    state_bytes = cells * lane_round + flags
    log(f'  lane state over the rounds: {cells} lane-rounds x {lane_round} B '
        f'+ {flags} B of done flags read by {launches["cell_pass"]} launches '
        f'= {state_bytes} B, '
        f'{state_bytes / PEAK_BYTES_S * 1e3:.4f} ms at '
        f'{PEAK_BYTES_S / 1e12:.2f} TB/s (beside the bound\'s '
        f'{bounds["cell_pass"][2]["bytes"]} B: rays and answers once, each '
        f'table once)')

    # ---- 9. the box and the bench city loaded from Hydra XML libraries ---
    # written by the port's writer (the JAX package's files byte for byte),
    # loaded by load_scene, held table by table against build_scene of the
    # same description (phases 2 and 5), and rendered with the seeds of
    # phases 4 and 5: K1 (both entry points) and K2/K3
    def same_tables(label, a, b):
        ta, tb = a.to_numpy(), b.to_numpy()
        for name, x, y in (('st_wide', a.st_wide, b.st_wide),
                           ('cl_wide', a.cl_wide, b.cl_wide)):
            if (x is None) != (y is None):
                raise RuntimeError(f'{label}: {name} on one side only')
            # (node records hold int32 references: compare bits)
            for w_, t_ in ((x, ta), (y, tb)):
                for k, v in ({} if w_ is None else w_.tensors()).items():
                    t_[f'{name}_{k}'] = v.cpu().numpy().view(np.int32)
        if sorted(ta) != sorted(tb):
            raise RuntimeError(f'{label}: other tables {sorted(ta)} / '
                               f'{sorted(tb)}')
        for k in ta:
            x, y = ta[k], tb[k]
            ok = x.shape == y.shape and (
                np.array_equal(x, y) if x.dtype.kind in 'iub'
                else np.allclose(x, y, rtol=1e-6, atol=0))
            if not ok:
                raise RuntimeError(f'{label}: table {k} differs')
        log(f'  {label}: all {len(ta)} tables equal to build_scene\'s '
            '(integers exactly, floats to rtol 1e-6; the texture slots '
            'numbered alike, both builds going through one loader)')

    def lib_bytes(d):
        return sum(os.path.getsize(os.path.join(r, f))
                   for r, _, fs in os.walk(d) for f in fs)

    from hydracore3_torch import api
    with tempfile.TemporaryDirectory() as tmp:
        box_dir, city_dir = (os.path.join(tmp, k) for k in ('box', 'city'))
        box_desc = synth.build_box(1024, 768, depth=6, textured=True)
        t0 = time.perf_counter()
        box_xml = api.write_library(box_desc, box_dir)
        box_w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lbox, lbmeta = B.load_scene(box_xml, device=dev)
        torch.cuda.synchronize()
        box_l_s = time.perf_counter() - t0
        log(f'[9] the textured box as a library: {lib_bytes(box_dir)} B on '
            f'disk, written in {box_w_s:.3f} s, load_scene {box_l_s:.3f} s')
        same_tables('loaded box', lbox,
                    B.build_scene(box_desc, device=dev)[0])
        if not MK.supported(lbox, lbmeta) or lbmeta.use_stream:
            raise RuntimeError('the loaded box is not routed to K1')
        for name, regen in (('mega_sample', False), ('mega_regen', True)):
            zero_counts()
            im, tm = R.render(lbox, lbmeta, spp=BOX_SPP, regen=regen,
                              return_timing=True)
            n_l = (MK.regen_pass if regen else MK.sample_pass).launches
            p, m_ = psnr_mean(im, gold_box)
            diff = float(np.abs(im[..., :3] - box_imgs[name]).max())
            log(f'  loaded box, render {"regen" if regen else "fixed"} '
                f'{BOX_SPP} spp: {tm["total_s"]:.3f} s, launches {n_l}, '
                f'non-finite lane samples {tm["nonfinite"]}; max abs '
                f'difference from phase 5\'s image {diff:.3e}; vs golden '
                f'PSNR {p:.2f} dB, mean {100 * m_:.3f}% off')
            if n_l == 0 or tm['nonfinite'] or not np.isfinite(im).all():
                raise RuntimeError(f'loaded box {name}: {n_l} launches, '
                                   f'{tm["nonfinite"]} non-finite samples')
            if p < PSNR_MIN or m_ > MEAN_TOL:
                raise RuntimeError(f'loaded box {name} off the golden: '
                                   f'PSNR {p:.2f} dB, mean '
                                   f'{100 * m_:.3f}% off')
        del lbox

        city_desc = synth.build_city(width=1024, height=1024, depth=5,
                                     textured=True)
        t0 = time.perf_counter()
        city_xml = api.write_library(city_desc, city_dir)
        city_w_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcity, lcmeta = B.load_scene(city_xml, device=dev)
        torch.cuda.synchronize()
        city_l_s = time.perf_counter() - t0
        city_b = lib_bytes(city_dir)
        log(f'  the bench city as a library: {city_b} B on disk, written '
            f'in {city_w_s:.3f} s; load_scene {city_l_s:.3f} s on the host '
            f'({card})')
        same_tables('loaded bench city', lcity, scene)
        zero_counts()
        im, tm = R.render(lcity, lcmeta, spp=spp, integrator='mispt',
                          tile_size=1 << 20, return_timing=True)
        n9 = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                   TDD.intersect_march)}
        p, m_ = psnr_mean(im, gold)
        diff = float(np.abs(im[..., :3] - city_img[..., :3]).max())
        log(f'  loaded bench city, render {spp} spp: {tm["total_s"]:.2f} s, '
            f'launches {n9}, non-finite lane samples {tm["nonfinite"]}; max '
            f'abs difference from phase 4\'s image {diff:.3e}; vs golden '
            f'PSNR {p:.2f} dB, mean {100 * m_:.3f}% off')
        if 0 in n9.values() or tm['nonfinite'] or not np.isfinite(im).all():
            raise RuntimeError(f'loaded city: launches {n9}, '
                               f'{tm["nonfinite"]} non-finite samples')
        if p < PSNR_MIN or m_ > MEAN_TOL:
            raise RuntimeError(f'loaded city off the golden: PSNR {p:.2f} '
                               f'dB, mean {100 * m_:.3f}% off')
        del lcity

    csrc = 'hydracore3_torch/csrc/'
    src = {'intersect_stream': csrc + 'traverse_wide.cuh',
           'intersect_march': csrc + 'traverse_wide.cuh',
           'mega_sample': csrc + 'megakernel.cu',
           'mega_regen': csrc + 'megakernel.cu',
           'intersect_tlas': csrc + 'traverse_wide.cuh',
           'intersect_clusters': csrc + 'traverse_wide.cuh',
           'cell_pass': csrc + 'traverse.cu'}
    replaces = {'intersect_stream': 'hydracore3_tpu/accel/traverse_stream.py:59',
                'intersect_march': 'hydracore3_tpu/accel/traverse_dda.py:563',
                'mega_sample': 'hydracore3_tpu/models/megakernel.py:2086',
                'mega_regen': 'hydracore3_tpu/models/megakernel.py:2321',
                'intersect_tlas': 'hydracore3_tpu/accel/traverse_tlas.py:49',
                'intersect_clusters':
                    'hydracore3_tpu/accel/traverse_pallas.py:43',
                'cell_pass': 'hydracore3_tpu/accel/traverse_dda.py:179'}
    kernels = [dict(name=n, route='cuda', source=src[n], replaces=replaces[n],
                    launches=launches[n], max_abs_err=errs[n], ms=ms[n],
                    plain_ms=plain_ms[n], bound_ms=bounds[n][0],
                    bound_by=bounds[n][1], library_ms=None) for n in src]
    if DEFERRED:
        raise RuntimeError('; '.join(DEFERRED))
    log(card)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
