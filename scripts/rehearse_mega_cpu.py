#!/usr/bin/env python3
"""Rehearse the megakernel K1 (csrc/megakernel.cu) on the CPU.

    python scripts/rehearse_mega_cpu.py

No card is needed.  The CUDA source is compiled with g++: a stub
``cuda_runtime.h`` defines the CUDA keywords away (``__ldg`` a plain load,
``rsqrtf`` as ``1 / sqrtf``), each ``<<<...>>>`` launch becomes a loop over
block and thread ids, and ``-ffp-contract=off`` keeps the plain version's
rounding, as ``-fmad=false`` does on the card.  Two libraries are built into
``hydracore3_torch/_build/rehearse/``, the shipped variant and the counting
one (``-DHC3_COUNT``), and their C entry points are called on CPU tensors.
Both entry points run on the textured box (64 x 48) and on the box with its
walls cut into grids (``wall_subdiv`` 4 and 20, 32 x 24), against
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
#include <cmath>
#include <cstring>
#include <math.h>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) alignas(n)
struct alignas(16) float4 { float x, y, z, w; };
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
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                                     F) {
  a->numRegs = 0; a->localSizeBytes = 0; return 0; }
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long o = *p; *p += v; return o; }
template <class T> inline T __ldg(const T* p) { return *p; }
inline float __uint2float_rn(unsigned u) { return (float)u; }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
'''


def build(defines=()):
    """The CPU library of csrc/megakernel.cu with the given -D macros."""
    out = os.path.join(BUILD_DIR, 'rehearse')
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, 'cuda_runtime.h'), 'w') as f:
        f.write(STUB)
    with open(MK._CU_SRC) as f:
        src = f.read()
    src = re.sub(r'(\w+)<<<([^,]+), ([^,]+), 0,\s*(.*?)>>>',
                 r'for (blockIdx.x = 0; blockIdx.x < (unsigned)(\2); '
                 r'++blockIdx.x) for (threadIdx.x = 0; threadIdx.x < '
                 r'(unsigned)(\3); ++threadIdx.x) \1', src, flags=re.S)
    cpp = os.path.join(out, 'megakernel_cpu.cpp')
    with open(cpp, 'w') as f:
        f.write(src)
    path, _ = build_shared_library(
        '-'.join(['rehearse-mega', *defines]).lower(), [cpp],
        ['g++', '-O2', '-std=c++17', '-ffp-contract=off', '-shared', '-fPIC',
         f'-I{out}', *(f'-D{d}' for d in defines)])
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hc3_mega_sample.argtypes = [p, i, i, i, p, p, i, i, p, p, p]
    lib.hc3_mega_regen.argtypes = [p, i, i, i, p, p, p, i, i, i, i, p, p, p]
    if 'HC3_COUNT' in defines:
        lib.hc3_mega_counts_read.argtypes = [p]
    return lib


def tables(pk):
    w = pk.wide
    return (ctypes.c_void_p * 9)(*(t.data_ptr() for t in (
        w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light, pk.tex,
        pk.consts, pk.texels)))


def sample(lib, pk, xy, su, depth):
    n = xy.shape[1]
    contrib = torch.empty((4, n))
    su_out = torch.empty((3, n), dtype=torch.int64)
    rc = lib.hc3_mega_sample(tables(pk), pk.wide.stack, pk.texels.shape[0],
                             int(not pk.tex_const), xy.data_ptr(),
                             su[:2].contiguous().data_ptr(), depth, n,
                             contrib.data_ptr(), su_out.data_ptr(), None)
    assert rc == 0, rc
    return contrib, su_out


def regen(lib, pk, xy, sf, su, k, depth, first):
    n = xy.shape[1]
    sf_in = torch.zeros((MK.RF_NROWS, n)) if first else sf
    su_in = su[:2 if first else MK.RU_NROWS].contiguous()
    sf_out = torch.empty((MK.RF_NROWS, n))
    su_out = torch.empty((MK.RU_NROWS, n), dtype=torch.int64)
    rc = lib.hc3_mega_regen(tables(pk), pk.wide.stack, pk.texels.shape[0],
                            int(not pk.tex_const), xy.data_ptr(),
                            sf_in.data_ptr(), su_in.data_ptr(), int(first), k,
                            depth, n, sf_out.data_ptr(), su_out.data_ptr(),
                            None)
    assert rc == 0, rc
    return sf_out, su_out


def main():
    from hydracore3_torch.scene import synth
    lib, count_lib = build(), build(('HC3_COUNT',))
    for sub, w, h in ((1, 64, 48), (4, 32, 24), (20, 32, 24)):
        scene, meta = synth.box_scene(w, h, depth=6, textured=True,
                                      wall_subdiv=sub, device='cpu')
        pk = MK.pack(scene, meta)
        xy, su = MK.lane_setup(meta, 'cpu')
        depth, it = meta.trace_depth, MK.REGEN_ITERS
        label = (f'box wall_subdiv {sub} ({meta.num_tris} triangles, '
                 f'{pk.wide.nodes.shape[0]} wide nodes, stack '
                 f'{pk.wide.stack}), {xy.shape[1]} lanes')
        k = sample(lib, pk, xy, su, depth)
        p = MK.sample_pass_plain(pk, xy, su, depth)
        print(f'{label}: fixed chain close, RNG/flags equal, max|d| '
              f'{MK.lanes_agree(k, p, 3)}')
        sf, su_r = regen(lib, pk, xy, None, su, it, depth, True)
        k = regen(lib, pk, xy, sf, su_r, it, depth, False)
        sf_p, su_p = MK.regen_iters_plain(pk, xy, None, su, it, depth,
                                          first=True)
        p = MK.regen_iters_plain(pk, xy, sf_p, su_p, it, depth)
        print(f'{label}: regen close, RNG/flags equal, max|d| '
              f'{MK.lanes_agree(k, p, MK.RU_NROWS)}')
        n = xy.shape[1]
        for name, run in (('fixed chain pass', lambda: sample(
                count_lib, pk, xy, su, depth)),
                ('regen launch', lambda: regen(count_lib, pk, xy, sf, su_r,
                                               it, depth, False))):
            count_lib.hc3_mega_counts_reset()
            run()
            c = (ctypes.c_uint64 * 3)()
            count_lib.hc3_mega_counts_read(c)
            print(f'  counting build, {name}: per lane {c[0] / n:.3f} Woop '
                  f'tests, {c[1] / n:.3f} child-box tests, {c[2] / n:.3f} '
                  f'shades')


if __name__ == '__main__':
    main()
