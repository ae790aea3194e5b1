#!/usr/bin/env python3
"""Rehearse the megakernel K1 (csrc/megakernel.cu) on the CPU.

    python scripts/rehearse_mega_cpu.py

No card is needed. The CUDA source is compiled with g++: a stub
``cuda_runtime.h`` defines the CUDA keywords away (``__ldg`` a plain load,
``rsqrtf`` as ``1 / sqrtf``, ``cp.async`` a ``memcpy``), each ``<<<...>>>``
launch runs its blocks one after another, each block as one ``std::thread``
per CUDA thread over its own shared memory, with a C++20 ``std::barrier``
for ``__syncthreads`` and the warp votes (``__match_any_sync``,
``__shfl_sync``) exchanged over groups of 32 threads; the card is two SMs
holding one block each, so a launch's pools are shared between two
persistent blocks. ``-ffp-contract=off`` keeps the plain version's
rounding, as ``-fmad=false`` does on the card. Two libraries are built into
``hydracore3_torch/_build/rehearse/``, the shipped variant and the counting
one (``-DHC3_COUNT``), and their C entry points are called on CPU tensors.
Both entry points run on the textured box (64 x 48) and on the box with its
walls cut into grids (``wall_subdiv`` 4 and 20, 32 x 24), then on the
material zoo box (``tests/zoo_scenes.py``, 48 x 36) with each integrator's
variant, then on the spectral box (``write_spectral_box``, 48 x 36) with
each integrator's spectral variant (``-DHC3_SPECTRAL=1``), against
``sample_pass_plain`` and ``regen_iters_plain`` on the same pack; the share
of lanes whose RNG, flags and counts are equal is printed (1.0 expected up
to the few lanes where libm's sinf / cosf / sqrt differ from torch's by an
ulp), and the counting build's Woop tests, child-box tests and shades per
lane.  What a card run then measures (times, registers) cannot be seen here.
"""
import ctypes
import os
import re
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from hydracore3_torch.models import megakernel as MK  # noqa: E402
from hydracore3_torch.utils.native import (BUILD_DIR,  # noqa: E402
                                           PKG_DIR, build_shared_library)

STUB = '''#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) alignas(n)
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w}; }
struct alignas(16) int4 { int x, y, z, w; };
struct Dim { unsigned x; };
// a block runs as one std::thread per CUDA thread: its barrier, its
// warps' exchange slots and barriers, its shared memory
struct Warp { std::barrier<> bar{32}; int slot[32]; };
static thread_local Dim blockIdx, threadIdx;
static Dim gridDim;
static thread_local std::barrier<>* hc3_bar;
static thread_local Warp* hc3_warp;
static thread_local char* hc3_smem;
inline void __syncthreads() { hc3_bar->arrive_and_wait(); }
inline unsigned __match_any_sync(unsigned, int v) {
  Warp& w = *hc3_warp;
  w.slot[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int j = 0; j < 32; ++j) m |= (w.slot[j] == v ? 1u : 0u) << j;
  w.bar.arrive_and_wait();
  return m; }
inline int __shfl_sync(unsigned, int v, int src) {
  Warp& w = *hc3_warp;
  w.slot[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  int r = w.slot[src];
  w.bar.arrive_and_wait();
  return r; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
using std::max; using std::min;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 0,
       cudaDevAttrMultiProcessorCount = 0 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// two SMs holding one block each: a launch's pools spread over two blocks
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2; return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) {
  return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, int) { *n = 1; return 0; }
template <class T> cudaError_t cudaMemcpyToSymbol(T& s, const void* p,
                                                  size_t n) {
  memcpy(&s, p, n); return 0; }
template <class T> cudaError_t cudaMemcpyFromSymbol(void* p, T& s,
                                                    size_t n) {
  memcpy(p, &s, n); return 0; }
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes,
                            sharedSizeBytes; };
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                                     F) {
  a->numRegs = 0; a->localSizeBytes = a->sharedSizeBytes = 0; return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __uint2float_rn(unsigned u) { return (float)u; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
// a launch: the blocks one after another, each block's threads at once
template <class F> void hc3_launch(int grid, int block, int shmem, F body) {
  gridDim.x = (unsigned)grid;
  for (int b = 0; b < grid; ++b) {
    std::unique_ptr<float4[]> sm(new float4[(shmem + 15) / 16 + 1]);
    std::barrier<> bar(block);
    std::unique_ptr<Warp[]> warps(new Warp[(block + 31) / 32]);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        blockIdx.x = (unsigned)b; threadIdx.x = (unsigned)t;
        hc3_bar = &bar; hc3_warp = &warps[t / 32];
        hc3_smem = reinterpret_cast<char*>(sm.get());
        body(); });
    for (auto& th : ts) th.join();
  }
}
'''

N_COUNTS = 8    # Woop tests, child-box tests, shades of six material kinds


def build(defines=()):
    """The CPU library of csrc/megakernel.cu with the given -D macros."""
    out = os.path.join(BUILD_DIR, 'rehearse')
    os.makedirs(out, exist_ok=True)
    stub = os.path.join(out, 'cuda_runtime.h')
    with open(stub, 'w') as f:
        f.write(STUB)
    with open(MK._CU_SRC) as f:
        src = f.read()
    src = src.replace('extern __shared__ float4 smem[];',
                      'float4* smem = reinterpret_cast<float4*>(hc3_smem);')
    src = re.sub(r'(\w+)<<<([^,]+), ([^,]+), ([^,]+),\s*(.*?)>>>\((.*?)\);',
                 r'hc3_launch(\2, \3, \4, [&]() { \1(\6); });', src,
                 flags=re.S)
    cpp = os.path.join(out, 'megakernel_cpu.cpp')
    with open(cpp, 'w') as f:
        f.write(src)
    path, _ = build_shared_library(
        '-'.join(['rehearse-mega', *defines]).lower(), [cpp],
        ['g++', '-O2', '-std=c++20', '-pthread', '-ffp-contract=off',
         '-shared', '-fPIC', f'-I{out}', *(f'-D{d}' for d in defines)],
        headers=(stub,))
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hc3_mega_sample.argtypes = [p, p, p, p, i, i, p, p, p]
    lib.hc3_mega_regen.argtypes = [p, p, p, p, p, i, i, i, i, p, p, p]
    if 'HC3_COUNT' in defines:
        lib.hc3_mega_counts_read.argtypes = [p]
    return lib


def tables(pk):
    w = pk.wide
    tabs = [w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light, pk.tex,
            pk.consts, pk.texels]
    if pk.spectral:
        tabs += [pk.spd, pk.spd_off, pk.cie]
    return (ctypes.c_void_p * len(tabs))(*(t.data_ptr() for t in tabs))


def variant_libs(variant):
    """The shipped and counting CPU builds of one kernel variant."""
    d = MK.variant_defines(variant)
    return build(d), build(d + ('HC3_COUNT',))


def sample(lib, pk, xy, su, depth):
    n = xy.shape[1]
    contrib = torch.empty((4, n))
    su_out = torch.empty((3, n), dtype=torch.int64)
    rc = lib.hc3_mega_sample(tables(pk), MK._dims(pk), xy.data_ptr(),
                             su[:2].contiguous().data_ptr(), depth, n,
                             contrib.data_ptr(), su_out.data_ptr(), None)
    assert rc == 0, rc
    return contrib, su_out


def regen(lib, pk, xy, sf, su, k, depth, first):
    n = xy.shape[1]
    rows = MK.rf_nrows(pk.spectral)
    sf_in = torch.zeros((rows, n)) if first else sf
    su_in = su[:2 if first else MK.RU_NROWS].contiguous()
    sf_out = torch.empty((rows, n))
    su_out = torch.empty((MK.RU_NROWS, n), dtype=torch.int64)
    rc = lib.hc3_mega_regen(tables(pk), MK._dims(pk), xy.data_ptr(),
                            sf_in.data_ptr(), su_in.data_ptr(), int(first), k,
                            depth, n, sf_out.data_ptr(), su_out.data_ptr(),
                            None)
    assert rc == 0, rc
    return sf_out, su_out


def rehearse(label, pk, xy, su, depth, integrator, lib, count_lib):
    it = MK.REGEN_ITERS
    k = sample(lib, pk, xy, su, depth)
    p = MK.sample_pass_plain(pk, xy, su, depth, integrator)
    print(f'{label}: fixed chain close, RNG/flags equal, max|d| '
          f'{MK.lanes_agree(k, p, 3)}')
    sf, su_r = regen(lib, pk, xy, None, su, it, depth, True)
    k = regen(lib, pk, xy, sf, su_r, it, depth, False)
    sf_p, su_p = MK.regen_iters_plain(pk, xy, None, su, it, depth,
                                      first=True, integrator=integrator)
    p = MK.regen_iters_plain(pk, xy, sf_p, su_p, it, depth,
                             integrator=integrator)
    print(f'{label}: regen close, RNG/flags equal, max|d| '
          f'{MK.lanes_agree(k, p, MK.RU_NROWS)}')
    n = xy.shape[1]
    for name, run in (('fixed chain pass', lambda: sample(
            count_lib, pk, xy, su, depth)),
            ('regen launch', lambda: regen(count_lib, pk, xy, sf, su_r,
                                           it, depth, False))):
        count_lib.hc3_mega_counts_reset()
        run()
        c = (ctypes.c_uint64 * N_COUNTS)()
        count_lib.hc3_mega_counts_read(c)
        shades = ', '.join(f'{c[2 + j] / n:.3f}' for j in range(6))
        print(f'  counting build, {name}: per lane {c[0] / n:.3f} Woop '
              f'tests, {c[1] / n:.3f} child-box tests, shades (GLTF, '
              f'diffuse, conductor, dielectric, glass, light) {shades}')


def main():
    import tempfile
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import zoo_scenes
    lib, count_lib = variant_libs(MK.DEFAULT_VARIANT)
    for sub, w, h in ((1, 64, 48), (4, 32, 24), (20, 32, 24)):
        scene, meta = synth.box_scene(w, h, depth=6, textured=True,
                                      wall_subdiv=sub, device='cpu')
        pk = MK.pack(scene, meta)
        xy, su = MK.lane_setup(meta, 'cpu')
        label = (f'box wall_subdiv {sub} ({meta.num_tris} triangles, '
                 f'{pk.wide.nodes.shape[0]} wide nodes, stack '
                 f'{pk.wide.stack}), {xy.shape[1]} lanes')
        rehearse(label, pk, xy, su, meta.trace_depth, MK.INTEGRATOR_MIS_PT,
                 lib, count_lib)
    with tempfile.TemporaryDirectory() as d:
        scene, meta = B.load_scene(zoo_scenes.write_zoo_box(d, 48, 36, 6),
                                   device='cpu')
    pk = MK.pack(scene, meta)
    xy, su = MK.lane_setup(meta, 'cpu')
    for name, itype in MK.INTEGRATOR_BY_NAME.items():
        v = MK.variant_of(pk, itype)
        rehearse(f'zoo box, {name}, variant {v}', pk, xy, su,
                 meta.trace_depth, itype, *variant_libs(v))
    with tempfile.TemporaryDirectory() as d:
        scene, meta = B.load_scene(
            zoo_scenes.write_spectral_box(d, 48, 36, 6), spectral_mode=True,
            device='cpu')
    pk = MK.pack(scene, meta)
    xy, su = MK.lane_setup(meta, 'cpu')
    for name, itype in MK.INTEGRATOR_BY_NAME.items():
        v = MK.variant_of(pk, itype)
        rehearse(f'spectral box, {name}, variant {v}', pk, xy, su,
                 meta.trace_depth, itype, *variant_libs(v))


if __name__ == '__main__':
    main()
