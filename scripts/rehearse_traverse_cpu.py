#!/usr/bin/env python3
"""Rehearse the port's ray-query kernels (csrc/traverse.cu) on the CPU.

    python scripts/rehearse_traverse_cpu.py [--pixels 16384]

No card is needed.  The CUDA source (with csrc/traverse_wide.cuh) is compiled
with g++: a stub ``cuda_runtime.h`` defines the CUDA keywords away, each
``<<<...>>>`` launch becomes a loop over block and thread ids, and
``-ffp-contract=off`` keeps the arithmetic of the plain torch versions (a
warp's vote is the one thread's own, so K6's count of live lanes grows one
lane at a time).  Two libraries are built into
``hydracore3_torch/_build/rehearse/``, the shipped variant and the counting
one (``-DHC3_COUNT``), and their C entry points are called on CPU tensors:

1. the small city of tests/test_torch_scene.py, streamed: K2 (nearest and
   any-hit) and K3 against ``intersect_plain`` and ``walk_wide_plain`` on its
   camera and shadow rays and on random rays, and K3 on rays that start on
   cell faces; K6 (nearest and any-hit, ``intersect_dda``'s loop over the
   grid without outliers) against ``intersect_plain``, and its state after
   every round against ``cell_pass_plain``'s from the same state; the share
   of lanes with equal t, tri, u, v is printed (1.0 expected on every lane)
   and unresolved march lanes counted;
2. the bench city (``city_scene(width=1024, height=1024, depth=5,
   textured=True)``, 215,554 triangles) on the CPU, on ``--pixels`` pixels
   drawn from a seed: box tests, triangle tests and grid cells per ray of
   K2's, K3's and K6's queries of the first bounce, as the counting build
   reports them (per-ray counts do not depend on the order the rays are
   traced in), and K6's rounds.

What a card run then measures (times, registers) cannot be seen here.
"""
import argparse
import ctypes
import os
import re
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hydracore3_torch.accel import traverse_dda as TDD  # noqa: E402
from hydracore3_torch.accel import traverse_stream as TST  # noqa: E402
from hydracore3_torch.accel import wide_bvh as WB  # noqa: E402
from hydracore3_torch.utils.native import (BUILD_DIR,  # noqa: E402
                                           PKG_DIR, build_shared_library)

STUB = '''#pragma once
#include <algorithm>
#include <cmath>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
#define __align__(n) alignas(n)
struct float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
struct Dim { unsigned x; };
static thread_local Dim blockIdx, threadIdx;
using std::max; using std::min;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return 0; }
template <class T> cudaError_t cudaMemcpyToSymbol(T& s, const void* p,
                                                  size_t n) {
  memcpy(&s, p, n); return 0; }
template <class T> cudaError_t cudaMemcpyFromSymbol(void* p, T& s,
                                                    size_t n) {
  memcpy(p, &s, n); return 0; }
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                         const void*) {
  a->numRegs = 0; a->localSizeBytes = 0; return 0; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long o = *p; *p += v; return o; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
// one thread at a time: a warp's vote is this thread's own
inline unsigned __ballot_sync(unsigned, bool p) {
  return p ? 1u << (threadIdx.x & 31) : 0u; }
inline int __ffs(unsigned x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) { int o = *p; *p += v; return o; }
'''


def build(defines=()):
    """The CPU library of csrc/traverse.cu with the given -D macros."""
    csrc = os.path.join(PKG_DIR, 'csrc')
    out = os.path.join(BUILD_DIR, 'rehearse')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'cuda_runtime.h'), 'w') as f:
        f.write(STUB)
    with open(os.path.join(csrc, 'traverse.cu')) as f:
        src = f.read()
    src = re.sub(r'(\w+(?:<\w+>)?)<<<([^,]+), ([^,]+), 0, s>>>',
                 r'for (blockIdx.x = 0; blockIdx.x < (unsigned)(\2); '
                 r'++blockIdx.x) for (threadIdx.x = 0; threadIdx.x < '
                 r'(unsigned)(\3); ++threadIdx.x) \1', src)
    cpp = os.path.join(out, 'traverse_cpu.cpp')
    with open(cpp, 'w') as f:
        f.write(src)
    path, _ = build_shared_library(
        '-'.join(['rehearse', *defines]).lower(), [cpp],
        ['g++', '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         '-Wno-unknown-pragmas',
         f'-I{out}', f'-I{csrc}', *(f'-D{d}' for d in defines)],
        (os.path.join(csrc, 'traverse_wide.cuh'),))
    lib = ctypes.CDLL(path)
    p, i, f_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hc3_intersect_stream.argtypes = [p] * 7 + [f_, i, i, i] + [p] * 5
    lib.hc3_intersect_march.argtypes = ([p] * 4 + [i] + [p] * 4 + [i, f_]
                                        + [p] * 4 + [f_, i] + [f_] * 6
                                        + [i] * 4 + [p] * 6)
    lib.hc3_cell_pass.argtypes = ([p] * 7 + [i, f_] + [p] * 4 + [f_, i]
                                  + [f_] * 6 + [i] * 5 + [p] * 9)
    return lib


def ptr(x):
    return x.data_ptr() if isinstance(x, torch.Tensor) else x.ctypes.data


def host_pack(w):
    return WB.WidePack(**{k: v.numpy() if isinstance(v, torch.Tensor) else v
                          for k, v in vars(w).items()})


def k2(lib, w, q, any_hit):
    pos, d, tmin, tmax = (x.to(torch.float32).contiguous() for x in q)
    n = pos.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int64)
    rc = lib.hc3_intersect_stream(
        ptr(w.nodes), ptr(w.rows), ptr(w.index), *map(ptr, (pos, d, tmin,
                                                            tmax)),
        TST.T_MAX_CAP, n, int(any_hit), w.stack, *map(ptr, (t, tri, u, v)),
        None)
    assert rc == 0, rc
    return t, tri, u, v


def k3(lib, g, w, q):
    pos, d, tmin, tmax = (x.to(torch.float32).contiguous() for x in q)
    n = pos.shape[0]
    t, u, v = torch.empty(n), torch.empty(n), torch.empty(n)
    tri = torch.empty(n, dtype=torch.int64)
    un = torch.empty(n, dtype=torch.int32)
    d0, d1, d2 = g.dims
    rc = lib.hc3_intersect_march(
        *map(ptr, (g.cell_tab, g.cell_cl, g.cl_aabb, g.outliers)),
        g.n_outliers, *map(ptr, (w.nodes, w.rows, w.index, w.cl_root)),
        w.cl_stack, w.margin, *map(ptr, (pos, d, tmin, tmax)), TST.T_MAX_CAP, n,
        *g.lo, *g.h, d0, d1, d2, 4 * (d0 + d1 + d2) + 64,
        *map(ptr, (t, tri, u, v, un)), None)
    assert rc == 0, rc
    return (t, tri, u, v), un


def k6_round(lib, g, w, q, state, any_hit, first, n_live):
    """One launch of K6 (``traverse_dda.cell_pass``'s arguments)."""
    d0, d1, d2 = g.dims
    rc = lib.hc3_cell_pass(
        *map(ptr, (g.cell_tab, g.cell_cl, g.cl_aabb, w.nodes, w.rows,
                   w.index, w.cl_root)), w.cl_stack, w.margin,
        *map(ptr, q), TST.T_MAX_CAP, q[0].shape[0], *g.lo, *g.h, d0, d1, d2,
        int(any_hit), int(first), *map(ptr, state), ptr(n_live), None)
    assert rc == 0, rc


def k6(lib, g, w, q, any_hit, woop=None, max_rounds=48):
    """``intersect_dda``'s loop on the card over the rehearsed K6.  With
    ``woop`` each round's state is held against ``cell_pass_plain``'s from
    the same state: returns ((t, tri, u, v), rounds, lanes left live, the
    share of lanes whose state equals the plain round's after the worst
    round, or None)."""
    q = tuple(x.to(torch.float32).contiguous() for x in q)
    n = q[0].shape[0]
    state = TDD.empty_state(n, 'cpu')
    counts = torch.zeros(max_rounds, dtype=torch.int32)
    tmax_c = torch.clamp(q[3], max=TST.T_MAX_CAP)
    plain = TDD.dda_entry(g, q[0], q[1], q[2], tmax_c) if woop is not None \
        else None
    worst, rounds, live = 1.0, 0, n
    while rounds < max_rounds and live > 0:
        k6_round(lib, g, w, q, state, any_hit, rounds == 0,
                 counts[rounds:rounds + 1])
        if plain is not None:
            plain = TDD.cell_pass_plain(g, woop, q[0], q[1], q[2], tmax_c,
                                        plain, any_hit)
            same = torch.ones(n, dtype=torch.bool)
            for a, b in zip(state, plain):
                same &= (a == b).reshape(n, -1).all(1)
            worst = min(worst, float(same.float().mean()))
        live = int(counts[rounds])
        rounds += 1
    return (state[3:], rounds, live,
            worst if plain is not None else None)


def equal(a, b):
    return {k: float((x == y).float().mean())
            for k, x, y in zip(('t', 'tri', 'u', 'v'), a, b)}


def first_bounce(scene, meta, pix, lib_q):
    """(camera, sorted shadow, first-bounce) queries of the pass on the
    given pixels; the integrator's queries go to the rehearsed kernels."""
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    w, g = host_pack(scene.st_wide), scene.st_grid
    IPT.nearest_hit = lambda sc, *q: k3(lib_q, g, w, q)[0]
    TST.intersect_stream = (lambda nf, ni, woop, *q, any_hit=False,
                            wide=None: k2(lib_q, w, q, any_hit))
    n = pix.shape[0]
    st = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix), pix)

    def nearest(state):
        live = ~IPT._is_dead(state.flags)
        return (state.ray_pos, state.ray_dir, torch.zeros(n),
                torch.where(live, IPT.LM.FLT_MAX, 0.0))

    cam = nearest(st)
    st = IPT.kernel_ray_trace(scene, meta, st, 0)
    ctx = IPT.MAT.make_shading_ctx(scene, meta, IPT._extract_mat_id(st.flags),
                                   st.hit_norm, st.hit_tang, st.hit_uv)
    _, _, _, rays = IPT.sample_shadow_rays(scene, meta, st)
    _, *shadow = IPT.sorted_shadow_query(scene.st_grid, rays)
    shade, rng2 = IPT.kernel_sample_light_source(scene, meta, st, ctx)
    st = IPT.kernel_next_bounce(scene, meta, st._replace(rng=rng2), 0, shade,
                                ctx)
    return cam, shadow, nearest(st)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--pixels', type=int, default=16384)
    args = ap.parse_args()
    from hydracore3_torch.scene import synth
    lib, count_lib = build(), build(('HC3_COUNT',))
    count_lib.hc3_counts_read.argtypes = [ctypes.c_void_p]

    # 1. the small city: every lane against the plain version and the walk
    scene, meta = synth.city_scene(
        n_blocks=4, subdiv=1, seed=3, width=32, height=16, depth=2,
        ground_subdiv=8, textured=True, accel='stream', device='cpu')
    w, g = host_pack(scene.st_wide), scene.st_grid
    g0 = TDD.pack_grid(scene.st_nodes_f.numpy(), scene.st_nodes_i.numpy(),
                       robust_aabb=False).to('cpu')
    n = meta.width * meta.height
    cam, shadow, _ = first_bounce(scene, meta, torch.arange(n), lib)
    rng = np.random.default_rng(3)
    m = 3000
    pos = rng.uniform(-25, 25, (m, 3)).astype(np.float32)
    pos[:, 1] = np.abs(pos[:, 1])
    pos[:m // 3, 0] = g.lo[0] + rng.integers(1, g.dims[0], m // 3) * g.h[0]
    d = rng.normal(size=(m, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rnd = (torch.from_numpy(pos), torch.from_numpy(d), torch.zeros(m),
           torch.full((m,), TST.T_MAX_CAP))
    for label, q in (('camera', cam), ('shadow', shadow),
                     ('random, a third on cell faces', rnd)):
        q = (*q[:3], torch.clamp(q[3], max=TST.T_MAX_CAP))
        for any_hit in (False, True):
            kk = k2(lib, w, q, any_hit)
            plain = TST.intersect_plain(scene.st_woop, *q, any_hit)
            walk = WB.walk_wide_plain(w, *q, any_hit)
            kind = 'any-hit' if any_hit else 'nearest'
            print(f'small city, {label}: K2 {kind} equal to plain '
                  f'{equal(kk, plain)}, to the walk {equal(kk, walk)}')
        km, un = k3(lib, g, w, q)
        print(f'small city, {label}: K3 equal to plain '
              f'{equal(km, TST.intersect_plain(scene.st_woop, *q))}, '
              f'{int(un.sum())} unresolved')
        for any_hit in (False, True):
            kd, rounds, live, same = k6(lib, g0, w, q, any_hit,
                                        woop=scene.st_woop)
            plain = TST.intersect_plain(scene.st_woop, *q, any_hit)
            print(f'small city, {label}: K6 {("nearest", "any-hit")[any_hit]}'
                  f' equal to plain {equal(kd, plain)}; {rounds} rounds, '
                  f'{live} lanes left live; lanes whose state equals the '
                  f'plain round\'s after the worst round: {same}')

    # 2. the bench city: tests per ray of the first bounce's queries
    scene, meta = synth.city_scene(width=1024, height=1024, depth=5,
                                   textured=True, device='cpu')
    w, g = host_pack(scene.st_wide), scene.st_grid
    t0 = time.perf_counter()
    WB.pack_wide_stream(*(getattr(scene, k).numpy() for k in (
        'st_nodes_f', 'st_nodes_i', 'st_woop', 'tri_v0', 'tri_e1', 'tri_e2')))
    print(f'bench city: {w.nodes.shape[0]} wide nodes, {w.rows.shape[0]} '
          f'rows, stack {w.stack}, cl_stack {w.cl_stack}; bytes '
          f'{w.nodes.nbytes} nodes, {w.rows.nbytes} rows, {w.index.nbytes} '
          f'index; packed again in {time.perf_counter() - t0:.2f} s')
    n = args.pixels
    pix = torch.from_numpy(np.sort(np.random.default_rng(0).choice(
        meta.width * meta.height, n, replace=False)))
    cam, shadow, bounce = first_bounce(scene, meta, pix, lib)
    g0 = TDD.pack_grid(scene.st_nodes_f.numpy(), scene.st_nodes_i.numpy(),
                       robust_aabb=False).to('cpu')
    k6_rounds = {}
    for label, run in (
            ('K2 nearest, camera', lambda: k2(count_lib, w, cam, False)),
            ('K2 any-hit, sorted shadow', lambda: k2(count_lib, w, shadow,
                                                     True)),
            ('K2 nearest, first bounce', lambda: k2(count_lib, w, bounce,
                                                    False)),
            ('K3 camera', lambda: k3(count_lib, g, w, cam)),
            ('K3 first bounce', lambda: k3(count_lib, g, w, bounce)),
            ('K6 nearest, camera', lambda: k6_rounds.update(
                camera=k6(count_lib, g0, w, cam, False)[1:3])),
            ('K6 nearest, first bounce', lambda: k6_rounds.update(
                bounce=k6(count_lib, g0, w, bounce, False)[1:3])),
            ('K6 any-hit, sorted shadow', lambda: k6_rounds.update(
                shadow=k6(count_lib, g0, w, shadow, True)[1:3]))):
        count_lib.hc3_counts_reset()
        run()
        c = (ctypes.c_uint64 * 4)()
        count_lib.hc3_counts_read(c)
        print(f'bench city, {label}: per ray {c[0] / n:.3f} box tests, '
              f'{c[1] / n:.3f} triangle tests, {c[3] / n:.3f} grid cells '
              f'({n} pixels)')
    print(f'bench city, K6 (rounds, lanes left live): {k6_rounds}')


if __name__ == '__main__':
    main()
