#!/usr/bin/env python3
"""Time the megakernel K1 on one CUDA card and split its time into trace
and shading.

    python3 scripts/k1_measure.py [--tree PATH] [--variants V1,V2,...]

``--tree`` names the root of a checkout whose ``hydracore3_torch`` is
measured (default: this one), so one call can measure a parent and a
change in turns.  On the textured box (``synth.box_scene(1024, 768,
depth=6, textured=True)``, 786,432 lanes) and on the same box with each
wall cut into a 20 x 20 grid (4,006 triangles; built here from the box's
own description, so a tree without ``wall_subdiv`` gets the same scene):

- registers and local bytes of both entry points, and the blocks an SM
  holds at that register count (128 threads a block, 65,536 registers an
  SM, allocated per warp in units of 256);
- milliseconds of one fixed-chain pass (``sample_pass``) and of one
  16-iteration regen launch (``regen_pass``), by CUDA events;
- a trace-only kernel built from the tree's own ``csrc/megakernel.cu``: the
  plain version's pass (``sample_pass_plain``) and regen launch
  (``regen_iters_plain``) are run once with their trace calls recorded, and
  the kernel replays every recorded nearest and shadow query of each lane
  through the tree's own trace functions, with no shading.  Trace ms over
  the entry point's ms is the trace share (the replay also reads its rays
  from memory, 28 bytes a query, which the real kernel does not);
- the operations of a pass and a launch: Woop tests x 45 + child-box tests
  x 25 + shades x SHADE_OPS (``chip_smoke.py``'s constants).  A tree with a
  brute trace tests every padded row on every traced query; a tree with a
  counting build (``-DHC3_COUNT``) counts its own tests.  Shades are the
  lanes the plain version shades.  With the bytes (lane state in and out,
  each table once) they give the bound, as ``chip_smoke.py`` computes it.

``--variants`` (the current tree only) builds the same source changed by
text substitution and measures each variant beside it on both scenes, with
its lanes held against the plain version on the box: ``minblocksN`` (both
kernels ``__launch_bounds__(128, N)``; the source has 6), ``noinline`` (the
trace walk a real call), ``shade_noinline`` (shade_hit a real call),
``visit_all`` (the walk culls no child, so a warp's lanes walk the same
nodes: a measure of what divergence costs) and ``anyhit_sort`` (the shadow
walk sorts a node's children as the nearest walk does); ``a+b`` applies
both.  The last line is a JSON record of
everything printed.
"""
import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# appended to the tree's megakernel.cu: the trace-only replay.  @LOCALS@,
# @ANY@, @NEAREST@, @PARAMS@ and @TABLES@ are filled per tree.
TRACE_ONLY = r'''
namespace {
__global__ void __launch_bounds__(BLOCK)
trace_only_kernel(Tables tb, const float* __restrict__ rays, unsigned kinds,
                  int q, int n, float* __restrict__ out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  @LOCALS@
  float acc = 0.0f;
  for (int j = 0; j < q; ++j) {
    const float* r = rays + (size_t)j * 7 * n + i;
    float tmax = r[(size_t)6 * n];
    if (!(tmax > 0.0f)) continue;
    V3 o = {r[0], r[(size_t)n], r[(size_t)2 * n]};
    V3 d = {r[(size_t)3 * n], r[(size_t)4 * n], r[(size_t)5 * n]};
    acc += ((kinds >> j) & 1u) ? @ANY@ : @NEAREST@;
  }
  out[i] = acc;
}
}  // namespace

extern "C" int hc3_trace_only(@PARAMS@, const void* rays, unsigned kinds,
                              int q, int n, void* out, void* stream) {
  trace_only_kernel<<<blocks(n), BLOCK, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      @TABLES@, static_cast<const float*>(rays), kinds, q, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''
BRUTE = dict(LOCALS='', PARAMS='const void* woop, int n_tris',
             TABLES='tables(woop, woop, woop, woop, woop, woop, woop, n_tris, '
                    '1, 0)',
             ANY='(trace_any(tb, o, d, tmax) ? 1.0f : 0.0f)',
             NEAREST='(float)trace_nearest(tb, o, d).tri')
WALK = dict(LOCALS='St s; HC3_ZERO(s); Entry stack[MEGA_STACK];',
            PARAMS='const void* const* tabs', TABLES='tables(tabs, 1, 0)',
            ANY='(float)trace<true>(tb, o, d, tmax, s, stack).tri',
            NEAREST='(float)trace<false>(tb, o, d, tmax, s, stack).tri')
VARIANTS = {
    'noinline': [('template <bool ANY_HIT>\n__device__ Hit trace(',
                  'template <bool ANY_HIT>\n__device__ __noinline__ Hit '
                  'trace(')],
    'shade_noinline': [('__device__ void shade_hit(',
                        '__device__ __noinline__ void shade_hit(')],
    # every child entered, none culled: all lanes of a warp walk the same
    # nodes and test the same rows (the results stay exact)
    'visit_all': [('  return tn <= tf ? tn : INFINITY;', '  return 0.0f;')],
    'anyhit_sort': [('      if (!ANY_HIT) {\n', '      {\n')],
}


def log(msg):
    print(msg, flush=True)


def blocks_per_sm(regs, block=128):
    per_warp = -(-regs * 32 // 256) * 256
    warps = min(65536 // max(per_warp, 1), 64)
    return min(warps // (block // 32), 32)


def grid_wall(m, n):
    """A wall mesh (4 corners, two triangles) cut into an n x n grid."""
    p0, p1, _, p3 = (m.pos[k].astype(np.float64) for k in range(4))
    a = np.arange(n + 1) / n
    pos = (p0 + a[:, None, None] * (p1 - p0)
           + a[None, :, None] * (p3 - p0)).reshape(-1, 3)
    i, j = (g.reshape(-1) for g in np.meshgrid(np.arange(n), np.arange(n),
                                               indexing='ij'))
    c00, c10 = i * (n + 1) + j, (i + 1) * (n + 1) + j
    ind = np.stack([np.stack([c00, c10, c10 + 1], 1),
                    np.stack([c00, c10 + 1, c00 + 1], 1)], 1).reshape(-1, 3)
    return dataclasses.replace(m, pos=pos.astype(np.float32), indices=ind,
                               mat_indices=np.full(len(ind),
                                                   m.mat_indices[0]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=HERE)
    ap.add_argument('--variants', default='')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('k1_measure: no CUDA device')
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as CS
    sys.path.insert(0, tree)
    for k in [k for k in sys.modules if k.startswith('hydracore3_torch')]:
        del sys.modules[k]
    from hydracore3_torch.accel import traverse_stream as TST
    from hydracore3_torch.models import megakernel as MK
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    from hydracore3_torch.utils.native import BUILD_DIR, build_shared_library
    assert MK.__file__.startswith(tree), MK.__file__
    walk = hasattr(MK, 'wide_table')
    dev = torch.device('cuda:0')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = dict(tree=tree, walk=walk, card=card)
    log(f'{card}; tree {tree} ({"wide walk" if walk else "brute trace"})')

    # ---- builds: the shipped source, the trace-only replay, the counting
    # build, the variants; one nvcc each, all at once
    src = open(MK._CU_SRC).read()
    os.makedirs(os.path.join(BUILD_DIR, 'k1'), exist_ok=True)

    def write(name, text):
        path = os.path.join(BUILD_DIR, 'k1', name + '.cu')
        with open(path, 'w') as f:
            f.write(text)
        return path

    fill = WALK if walk else BRUTE
    extra = TRACE_ONLY
    for k, v in fill.items():
        extra = extra.replace(f'@{k}@', v)
    trace_src = write('trace_only', src + extra)
    variants = [v for v in args.variants.split(',') if v]
    var_src = {}
    for v in variants:
        text = src
        for part in v.split('+'):
            if part.startswith('minblocks'):
                subs = [('constexpr int MIN_BLOCKS = 6;',
                         f'constexpr int MIN_BLOCKS = {int(part[9:])};')]
            else:
                subs = VARIANTS[part]
            for a, b in subs:
                assert a in text, (v, a)
                text = text.replace(a, b)
        var_src[v] = write(v.replace('+', '_'), text)
    flags = [TST._nvcc()] + MK._NVCC_FLAGS
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        jobs = {'shipped': pool.submit(MK.build_kernels),
                'trace': pool.submit(build_shared_library, 'k1-trace-only',
                                     [trace_src], flags)}
        if walk:
            jobs['count'] = pool.submit(MK.load_library, ('HC3_COUNT',))
        for v, path in var_src.items():
            jobs[v] = pool.submit(MK.load_library, (), path)
        done = {k: j.result() for k, j in jobs.items()}
    tlib = ctypes.CDLL(done['trace'][0])
    p, i_ = ctypes.c_void_p, ctypes.c_int
    tlib.hc3_trace_only.argtypes = ([p] if walk else [p, i_]) + [
        p, ctypes.c_uint, i_, i_, p, p]
    libs = {'shipped': MK._lib}
    libs.update({v: done[v][0] for v in variants})
    out['attrs'] = {}
    for name, lib in libs.items():
        a = MK.kernel_attrs(lib) if walk else MK.kernel_attrs()
        for k in a.values():
            k['blocks_per_sm'] = blocks_per_sm(k['registers'])
        out['attrs'][name] = a
        log(f'[{name}] {a}')

    # ---- the two scenes
    it = MK.REGEN_ITERS
    sd = synth.build_box(1024, 768, 6, textured=True)
    tess = dataclasses.replace(sd, meshes=[grid_wall(m, 20) if k < 5 else m
                                           for k, m in enumerate(sd.meshes)])
    scenes = {'box': B.build_scene(sd, device=dev),
              'tessellated box': B.build_scene(tess, device=dev)}
    out['scenes'] = {}
    for label, (scene, meta) in scenes.items():
        pk = MK.pack(scene, meta)
        xy, su = MK.lane_setup(meta, dev)
        n, depth = xy.shape[1], meta.trace_depth
        rec = dict(triangles=meta.num_tris, padded=pk.n_tris, lanes=n)
        if walk:
            rec.update(wide_nodes=pk.wide.nodes.shape[0],
                       stack=pk.wide.stack)
        log(f'{label}: {rec}')
        sf, su_r = MK.regen_pass(pk, xy, None, su, it, depth, first=True)

        def run(lib, regen):
            MK._lib = lib
            try:
                if regen:
                    return MK.regen_pass(pk, xy, sf, su_r, it, depth)
                return MK.sample_pass(pk, xy, su, depth)
            finally:
                MK._lib = libs['shipped']

        def ms(fn):
            _, first = CS.timed(fn)
            return CS.cuda_ms(fn, max(2, min(10, int(2000 / first))))

        times = {}
        for name, lib in libs.items():
            times[name] = dict(fixed_ms=ms(lambda: run(lib, False)),
                               regen_ms=ms(lambda: run(lib, True)))
            if name != 'shipped' and label == 'box':
                times[name]['fixed_agree'] = MK.lanes_agree(
                    run(lib, False), MK.sample_pass_plain(pk, xy, su, depth),
                    3)
                times[name]['regen_agree'] = MK.lanes_agree(
                    run(lib, True), MK.regen_iters_plain(pk, xy, sf, su_r, it,
                                                         depth), MK.RU_NROWS)
            log(f'  [{name}] {times[name]}')
        rec['times'] = times

        # the plain version, its trace calls and shaded lanes recorded
        queries, shades = [], [0]
        light = [None]
        trace0, shade0 = MK._trace_blocks, MK._shade

        def trace_rec(pk_, o, d, tmin, tmax, any_hit=False):
            t = torch.where(tmax > 0, tmax, 0.0)
            if any_hit and walk:        # the kernel skips lights' NEE
                t = torch.where(light[0], 0.0, t)
            queries.append((torch.cat([o, d, t[None]]).contiguous(),
                            any_hit, int((t > 0).sum())))
            return trace0(pk_, o, d, tmin, tmax, any_hit)

        def shade_rec(pk_, st, active, prim):
            shades[0] += int(active.sum())
            md = MK.fetch_mat(pk_, st['flags'] & 0x00FFFFFF)
            light[0] = md['mtype'] == float(MK.MTYPE_SMALL_LIGHT)
            return shade0(pk_, st, active, prim)

        for regen in (False, True):
            queries.clear()
            shades[0] = 0
            MK._trace_blocks, MK._shade = trace_rec, shade_rec
            try:
                if regen:
                    MK.regen_iters_plain(pk, xy, sf, su_r, it, depth)
                else:
                    MK.sample_pass_plain(pk, xy, su, depth)
            finally:
                MK._trace_blocks, MK._shade = trace0, shade0
            rays = torch.stack([q[0] for q in queries]).contiguous()
            kinds = sum(1 << j for j, q in enumerate(queries) if q[1])
            sink = torch.empty(n, device=dev)
            if walk:
                w = pk.wide
                tabs = (ctypes.c_void_p * 9)(*(t.data_ptr() for t in (
                    w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light,
                    pk.tex, pk.consts, pk.texels)))
                targs = (tabs,)
            else:
                targs = (pk.woop.data_ptr(), pk.n_tris)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def replay():
                TST.launch_checked('trace_only', tlib.hc3_trace_only(
                    *targs, rays.data_ptr(), kinds, len(queries), n,
                    sink.data_ptr(), stream))

            key = 'regen' if regen else 'fixed'
            traced = sum(q[2] for q in queries)
            r = dict(queries=len(queries), traced_lanes=traced,
                     nearest=sum(q[2] for q in queries if not q[1]),
                     shadow=sum(q[2] for q in queries if q[1]),
                     shades=shades[0], trace_ms=ms(replay))
            if walk:
                r['shipped_ms'] = times['shipped'][f'{key}_ms']
                with_counts = done['count'][0]
                TST.launch_checked('reset',
                                   with_counts.hc3_mega_counts_reset())
                run(with_counts, regen)
                torch.cuda.synchronize()
                c = (ctypes.c_uint64 * 3)()
                TST.launch_checked('read', with_counts.hc3_mega_counts_read(c))
                woop_t, slab_t, shade_t = (int(x) for x in c)
                tables = (pk.wide.nodes, pk.wide.rows, pk.wide.index)
            else:
                r['shipped_ms'] = times['shipped'][f'{key}_ms']
                woop_t, slab_t, shade_t = traced * pk.n_tris, 0, shades[0]
                tables = (pk.woop,)
            tables += (pk.shade, pk.mat, pk.light, pk.tex, pk.consts,
                       pk.texels)
            io = (328 if regen else 64) * n
            ops = (woop_t * CS.WOOP_OPS + slab_t * CS.SLAB_OPS
                   + shade_t * CS.SHADE_OPS)
            b_ms, by = CS.bound(io + CS.nbytes(*tables), ops)
            r.update(woop_tests=woop_t, box_tests=slab_t,
                     counted_shades=shade_t, operations=ops,
                     bytes=io + CS.nbytes(*tables),
                     bound_ms=b_ms, bound_by=by,
                     trace_share=r['trace_ms'] / r['shipped_ms'])
            rec[key] = r
            log(f'  {key}: {r}')
            del rays
        out['scenes'][label] = rec
        del pk, xy, su, sf, su_r
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
