#!/usr/bin/env python3
"""Time the megakernel K1 on one CUDA card and split its time into trace
and shading.

    python3 scripts/k1_measure.py [--tree PATH] [--variants V1,V2,...]
                                  [--scenes box,tessellated box,...]

``--tree`` names the root of a checkout whose ``hydracore3_torch`` is
measured (default: this one), so one call can measure a parent and a
change in turns.  The scenes, each at 1024 x 768 (786,432 lanes), depth 6:
the textured box (``synth.build_box(..., textured=True)``); the same box
with each wall cut into a 20 x 20 grid (4,006 triangles; built here from
the box's own description, so a tree without ``wall_subdiv`` gets the same
scene); the material zoo box and the spectral box
(``tests/zoo_scenes.py`` of the tree: ``write_zoo_box``,
``write_spectral_box`` loaded in spectral mode), each with the three
integrators (``naivept``, ``shadowpt``, ``mispt``), each its own K1
variant.  Per scene and integrator:

- registers, local bytes and shared bytes per block of both entry points
  (a tree whose ``kernel_attrs`` takes the pack: at this pack's layout,
  with the blocks an SM holds, the pool's lanes and where the geometry
  sits);
- milliseconds of one fixed-chain pass (``sample_pass``) and of one
  16-iteration regen launch (``regen_pass``), by CUDA events;
- a trace-only kernel built from the tree's own ``csrc/megakernel.cu``: the
  plain version's pass (``sample_pass_plain``) and regen launch
  (``regen_iters_plain``) are run once with their trace calls recorded, and
  the kernel replays every recorded nearest and shadow query of each lane
  through the tree's own trace functions, with no shading.  Trace ms over
  the entry point's ms is the trace share (the replay also reads its rays
  from memory, 28 bytes a query, which the real kernel does not);
- the operations of a pass and a launch, counted by the tree's counting
  build (``-DHC3_COUNT``): Woop tests x 45 + child-box tests x 25 + shades
  x ``chip_smoke.shade_ops`` by material kind (a spectral sample adds
  ``SPEC_SAMPLE_OPS``).  With the bytes (lane state in and out, each table
  once) they give the bound, as ``chip_smoke.py`` computes it.

``--variants`` (the current tree only) builds the same source changed by
text substitution and measures each beside it on the box, the tessellated
box and the ``mispt`` zoo and spectral boxes, with its lanes held against
the plain version: ``spoolN`` / ``rpoolN`` (N lanes a pool of the fixed
chain / regen), ``sminbN`` / ``rminbN`` (their ``__launch_bounds__(128,
N)``), ``stackchipN`` / ``geomN`` (the layout on chip up to a stack need of N
entries / N bytes of geometry; ``stackchip0``: every pack's geometry in
device memory and its stack local), ``noinline``
(the trace walk a real call), ``shade_noinline`` (shade_hit a real call),
``visit_all`` (the walk culls no child: a measure of what divergence
costs), ``anyhit_sort`` (the shadow walk sorts a node's children as the
nearest walk does), ``nosort`` (the live lanes shaded in one list, not
regrouped by material) and ``pooled`` (both entry points pooled in the
GLTF-only variant too, which runs them one lane a thread); ``a+b``
applies both.  The
last line is a JSON record of everything printed.
"""
import argparse
import concurrent.futures
import ctypes
import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# appended to the tree's megakernel.cu: the trace-only replay.  @SETUP@,
# @ANY@, @NEAREST@, @PARAMS@, @TABLES@ and @SHARED@ are filled per tree.
TRACE_ONLY = r'''
namespace {
__global__ void __launch_bounds__(BLOCK)
trace_only_kernel(Tables tb, const float* __restrict__ rays, unsigned kinds,
                  int q, int n, float* __restrict__ out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  @SETUP@
  if (i >= n) return;
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
  trace_only_kernel<<<(n + BLOCK - 1) / BLOCK, BLOCK, @SHARED@,
                      static_cast<cudaStream_t>(stream)>>>(
      @TABLES@, static_cast<const float*>(rays), kinds, q, n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''
# a tree whose walk keeps its stack in local memory (before the pools)
WALK_LOCAL = dict(SETUP='St s; HC3_ZERO(s); Entry stack[MEGA_STACK];',
                  PARAMS='const void* const* tabs', SHARED='0',
                  TABLES='tables(tabs, 1, 0)',
                  ANY='(float)trace<true>(tb, o, d, tmax, s, stack).tri',
                  NEAREST='(float)trace<false>(tb, o, d, tmax, s, stack).tri')
# a tree whose walk takes its layout from a Ctx: here the device-memory
# one (the pack's tables, a local stack)
WALK_SHARED = dict(
    SETUP='Ctx<false> cx; Entry stk[MEGA_STACK]; cx.stack = stk;',
    PARAMS='const void* const* tabs, const int* dims',
    SHARED='0', TABLES='tables(tabs, dims)',
    ANY='(float)trace<true>(tb, o, d, tmax, cx).tri',
    NEAREST='(float)trace<false>(tb, o, d, tmax, cx).tri')
VARIANTS = {
    'noinline': [('template <bool ANY_HIT, class C>\n__device__ Hit trace(',
                  'template <bool ANY_HIT, class C>\n__device__ __noinline__ '
                  'Hit trace(')],
    'shade_noinline': [('__device__ void shade_hit(',
                        '__device__ __noinline__ void shade_hit(')],
    # every child entered, none culled: all lanes of a warp walk the same
    # nodes and test the same rows (the results stay exact)
    'visit_all': [('  return tn <= tf ? tn : INFINITY;', '  return 0.0f;')],
    'anyhit_sort': [('      if (!ANY_HIT) {\n', '      {\n')],
    # the live lanes shaded in one list, not class by class
    'nosort': [('  return mat_class(\n', '  return 0 * mat_class(\n')],
    # both entry points pooled whatever the variant's material kinds (the
    # GLTF-only variant runs them one lane a thread)
    'pooled': [('  if constexpr (N_KINDS <= 1) {', '  if constexpr (false) {'),
               ('N_KINDS > 1 ? SAMPLE_POOL : 0', 'SAMPLE_POOL'),
               ('N_KINDS > 1 ? REGEN_POOL : 0', 'REGEN_POOL'),
               ('  L.pool = N_KINDS <= 1 ? 0', '  L.pool = false ? 0')],
}
# a constant of the source set by a variant's name: prefix -> constant
CONSTANTS = {'spool': 'SAMPLE_POOL', 'rpool': 'REGEN_POOL',
             'sminb': 'SAMPLE_MIN_BLOCKS', 'rminb': 'REGEN_MIN_BLOCKS',
             'stackchip': 'STACK_CHIP_MAX', 'geom': 'GEOM_CHIP_BYTES'}
INTEGRATORS = ('naivept', 'shadowpt', 'mispt')
SCENES = ('box', 'tessellated box', 'zoo box', 'spectral box')


def log(msg):
    print(msg, flush=True)


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


def substitute(src, variant):
    """The source of a text variant (``a+b``: both)."""
    text = src
    for part in variant.split('+'):
        pre = re.match(r'[a-z_]+', part).group(0)
        if pre in CONSTANTS and part[len(pre):].isdigit():
            pat = rf'constexpr int {CONSTANTS[pre]} = [^;]+;'
            assert re.search(pat, text), (variant, pre)
            text = re.sub(pat, f'constexpr int {CONSTANTS[pre]} = '
                          f'{int(part[len(pre):])};', text)
            continue
        for a, b in VARIANTS[part]:
            assert a in text, (variant, a)
            text = text.replace(a, b)
    return text


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=HERE)
    ap.add_argument('--variants', default='')
    ap.add_argument('--scenes', default=','.join(SCENES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit('k1_measure: no CUDA device')
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, HERE)
    import chip_smoke as CS
    sys.path.insert(0, tree)
    sys.path.insert(0, os.path.join(tree, 'tests'))
    for k in [k for k in sys.modules
              if k.startswith('hydracore3_torch') or k == 'zoo_scenes']:
        del sys.modules[k]
    from hydracore3_torch.accel import traverse_stream as TST
    from hydracore3_torch.models import megakernel as MK
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    from hydracore3_torch.utils.native import BUILD_DIR, build_shared_library
    import zoo_scenes
    assert MK.__file__.startswith(tree), MK.__file__
    assert zoo_scenes.__file__.startswith(tree), zoo_scenes.__file__
    dev = torch.device('cuda:0')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = dict(tree=tree, card=card)
    log(f'{card}; tree {tree}')
    scenes_on = [s for s in args.scenes.split(',') if s]

    # ---- the scenes and their variants
    it = MK.REGEN_ITERS
    todo = []           # (label, scene, meta, integrator name)
    sd = synth.build_box(1024, 768, 6, textured=True)
    if 'box' in scenes_on:
        todo.append(('box', *B.build_scene(sd, device=dev), 'mispt'))
    if 'tessellated box' in scenes_on:
        tess = dataclasses.replace(sd, meshes=[
            grid_wall(m, 20) if k < 5 else m
            for k, m in enumerate(sd.meshes)])
        todo.append(('tessellated box', *B.build_scene(tess, device=dev),
                     'mispt'))
    with tempfile.TemporaryDirectory() as tmp:
        for label, write, kw in (
                ('zoo box', zoo_scenes.write_zoo_box, {}),
                ('spectral box', zoo_scenes.write_spectral_box,
                 dict(spectral_mode=True))):
            if label in scenes_on:
                sc, mt = B.load_scene(write(tmp, 1024, 768, 6), device=dev,
                                      **kw)
                todo += [(label, sc, mt, name) for name in INTEGRATORS]
    packs = {}
    for label, sc, mt, _ in todo:
        if label not in packs:
            packs[label] = MK.pack(sc, mt)
    k1_vars = sorted({MK.variant_of(packs[lb], MK.INTEGRATOR_BY_NAME[nm])
                      for lb, _, _, nm in todo})

    # ---- builds: the shipped variants and their counting builds, the
    # trace-only replay, the text variants; one nvcc each, all at once
    src = open(MK._CU_SRC).read()
    shared_walk = 'struct Ctx {' in src
    os.makedirs(os.path.join(BUILD_DIR, 'k1'), exist_ok=True)

    def write(name, text):
        path = os.path.join(BUILD_DIR, 'k1', name + '.cu')
        with open(path, 'w') as f:
            f.write(text)
        return path

    extra = TRACE_ONLY
    for k, v in (WALK_SHARED if shared_walk else WALK_LOCAL).items():
        extra = extra.replace(f'@{k}@', v)
    trace_src = write('trace_only', src + extra)
    variants = [v for v in args.variants.split(',') if v]
    # the text variants run on the box's variant and the mispt zoo and
    # spectral boxes' variants
    mispt = MK.INTEGRATOR_BY_NAME['mispt']
    var_k1 = sorted({MK.variant_of(packs[lb], mispt) for lb in packs})
    var_src = {v: write(v.replace('+', '_'), substitute(src, v))
               for v in variants}
    flags = [TST._nvcc()] + MK._NVCC_FLAGS
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        jobs = {('shipped', v): pool.submit(MK.build_kernels, v)
                for v in k1_vars}
        jobs.update({('count', v): pool.submit(
            MK.load_library, MK.variant_defines(v) + ('HC3_COUNT',))
            for v in k1_vars})
        jobs['trace'] = pool.submit(build_shared_library, 'k1-trace-only',
                                    [trace_src], flags)
        for tv, path in var_src.items():
            for v in var_k1:
                jobs[(tv, v)] = pool.submit(MK.load_library,
                                            MK.variant_defines(v), path)
        done = {k: j.result() for k, j in jobs.items()}
    tlib = ctypes.CDLL(done['trace'][0])
    p, i_ = ctypes.c_void_p, ctypes.c_int
    tlib.hc3_trace_only.argtypes = ([p, p] if shared_walk else [p]) + [
        p, ctypes.c_uint, i_, i_, p, p]
    takes_pack = 'pk' in inspect.signature(MK.kernel_attrs).parameters

    def attrs(lib, pk):
        return MK.kernel_attrs(lib, pk) if takes_pack else \
            MK.kernel_attrs(lib)

    out['scenes'] = {}
    for label, scene, meta, name in todo:
        pk = packs[label]
        itype = MK.INTEGRATOR_BY_NAME[name]
        var = MK.variant_of(pk, itype)
        spectral = bool(pk.spectral)
        xy, su = MK.lane_setup(meta, dev)
        n, depth = xy.shape[1], meta.trace_depth
        libs = {'shipped': MK.kernel_library(var)}
        if var in var_k1 and (name == 'mispt'):
            libs.update({tv: done[(tv, var)][0] for tv in variants})
        rec = dict(integrator=name, variant=list(var),
                   triangles=meta.num_tris, padded=pk.n_tris, lanes=n,
                   wide_nodes=pk.wide.nodes.shape[0], stack=pk.wide.stack,
                   attrs={k: attrs(lib, pk) for k, lib in libs.items()})
        log(f'{label}, {name}: {rec}')
        sf, su_r = MK.regen_pass(pk, xy, None, su, it, depth, first=True,
                                 integrator=itype)

        def run(lib, regen):
            MK._lib = lib
            try:
                if regen:
                    return MK.regen_pass(pk, xy, sf, su_r, it, depth,
                                         integrator=itype)
                return MK.sample_pass(pk, xy, su, depth, itype)
            finally:
                MK._lib = None

        def ms(fn):
            # the median of 5 rounds of CUDA-event means
            _, first = CS.timed(fn)
            reps = max(2, min(20, int(200 / max(first, 1e-3))))
            return float(np.median([CS.cuda_ms(fn, reps)
                                    for _ in range(5)]))

        plain = {}
        times = {}
        for lname, lib in libs.items():
            times[lname] = dict(fixed_ms=ms(lambda: run(lib, False)),
                                regen_ms=ms(lambda: run(lib, True)))
            if lname != 'shipped':
                if not plain:
                    plain['fixed'] = MK.sample_pass_plain(pk, xy, su, depth,
                                                          itype)
                    plain['regen'] = MK.regen_iters_plain(
                        pk, xy, sf, su_r, it, depth, integrator=itype)
                times[lname]['fixed_agree'] = MK.lanes_agree(
                    run(lib, False), plain['fixed'], 3)
                times[lname]['regen_agree'] = MK.lanes_agree(
                    run(lib, True), plain['regen'], MK.RU_NROWS)
            log(f'  [{lname}] {times[lname]}')
        plain.clear()
        rec['times'] = times

        # the plain version, its trace calls and shaded lanes recorded
        queries, shades = [], [0]
        light = [None]
        trace0, shade0 = MK._trace_blocks, MK._shade

        def trace_rec(pk_, o, d, tmin, tmax, any_hit=False):
            t = torch.where(tmax > 0, tmax, 0.0)
            if any_hit:                 # the kernel skips lights' NEE
                t = torch.where(light[0], 0.0, t)
            queries.append((torch.cat([o, d, t[None]]).contiguous(),
                            any_hit, int((t > 0).sum())))
            return trace0(pk_, o, d, tmin, tmax, any_hit)

        def shade_rec(pk_, st, active, prim, *a, **kw):
            shades[0] += int(active.sum())
            md = MK.fetch_mat(pk_, st['flags'] & 0x00FFFFFF)
            light[0] = md['mtype'] == float(MK.MTYPE_SMALL_LIGHT)
            return shade0(pk_, st, active, prim, *a, **kw)

        w = pk.wide
        tabs_l = [w.nodes, w.rows, w.index, pk.shade, pk.mat, pk.light,
                  pk.tex, pk.consts, pk.texels]
        tables = tuple(tabs_l) + ((pk.spd, pk.spd_off, pk.cie)
                                  if spectral else ())
        for regen in (False, True):
            queries.clear()
            shades[0] = 0
            MK._trace_blocks, MK._shade = trace_rec, shade_rec
            try:
                if regen:
                    MK.regen_iters_plain(pk, xy, sf, su_r, it, depth,
                                         integrator=itype)
                else:
                    MK.sample_pass_plain(pk, xy, su, depth, itype)
            finally:
                MK._trace_blocks, MK._shade = trace0, shade0
            key = 'regen' if regen else 'fixed'
            r = dict(queries=len(queries),
                     traced_lanes=sum(q[2] for q in queries),
                     nearest=sum(q[2] for q in queries if not q[1]),
                     shadow=sum(q[2] for q in queries if q[1]),
                     shades=shades[0])
            if queries:
                rays = torch.stack([q[0] for q in queries]).contiguous()
                kinds = sum(1 << j for j, q in enumerate(queries) if q[1])
                sink = torch.empty(n, device=dev)
                targs = ((ctypes.c_void_p * 9)(*(t.data_ptr()
                                                 for t in tabs_l)),)
                if shared_walk:
                    targs += (MK._dims(pk),)
                stream = torch.cuda.current_stream(dev).cuda_stream

                def replay():
                    TST.launch_checked('trace_only', tlib.hc3_trace_only(
                        *targs, rays.data_ptr(), kinds, len(queries), n,
                        sink.data_ptr(), stream))

                r['trace_ms'] = ms(replay)
                del rays
            r['shipped_ms'] = times['shipped'][f'{key}_ms']
            with_counts = done[('count', var)][0]
            TST.launch_checked('reset', with_counts.hc3_mega_counts_reset())
            run(with_counts, regen)
            torch.cuda.synchronize()
            c = (ctypes.c_uint64 * 8)()
            TST.launch_checked('read', with_counts.hc3_mega_counts_read(c))
            cnt = [int(x) for x in c]
            rf = MK.rf_nrows(spectral)
            io = ((2 * (4 * rf + 8 * MK.RU_NROWS) + 8) if regen else 64) * n
            ops = (cnt[0] * CS.WOOP_OPS + cnt[1] * CS.SLAB_OPS
                   + CS.shade_ops(cnt, naive=itype == MK.INTEGRATOR_STUPID_PT,
                                  spectral=spectral)
                   + (CS.SPEC_SAMPLE_OPS * n if spectral else 0))
            b_ms, by = CS.bound(io + CS.nbytes(*tables), ops)
            r.update(woop_tests=cnt[0], box_tests=cnt[1],
                     counted_shades=cnt[2:], operations=ops,
                     bytes=io + CS.nbytes(*tables), bound_ms=b_ms,
                     bound_by=by)
            if 'trace_ms' in r:
                r['trace_share'] = r['trace_ms'] / r['shipped_ms']
            rec[key] = r
            log(f'  {key}: {r}')
        out['scenes'][f'{label}, {name}'] = rec
        del xy, su, sf, su_r
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
