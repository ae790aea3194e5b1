#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the exit code is not 0):
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. the bench city (``scene.synth.city_scene(width=1024, height=1024,
     depth=5, textured=True)``) built on the card;
  3. each CUDA kernel against its plain torch version on the queries of the
     render's first bounce, all 1,048,576 lanes each: the camera rays'
     nearest hit (K3, K2), the sorted shadow rays' any-hit (K2) and the
     sorted first-bounce rays' nearest hit (K3, K2); the march-vs-walk trace
     parity on the camera rays, and the count of unresolved march lanes (0);
  4. ``render.render`` at 16 spp through both kernels, with launch counts,
     a finite image, and PSNR / mean against tests/goldens/city_bench_128.npz.
The line before the last is a JSON record of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Needs no JAX and no network.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
AGREE_MIN = 0.999
PSNR_MIN = 35.0
MEAN_TOL = 0.02


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


def compare(name, kernel, plain):
    """Kernel vs plain: the share of rays whose hit flag agrees and, where
    both hit, whose t agrees to rtol 2e-4; max |dt| where both report the
    same triangle."""
    kt, ktri = kernel[0].cpu().numpy(), kernel[1].cpu().numpy()
    pt, ptri = plain[0].cpu().numpy(), plain[1].cpu().numpy()
    kh, ph = ktri >= 0, ptri >= 0
    both = kh & ph
    t_ok = np.isclose(kt[both], pt[both], rtol=2e-4, atol=1e-5)
    agree = float((kh == ph).mean() * (t_ok.mean() if both.any() else 1.0))
    same = both & (ktri == ptri)
    err = float(np.abs(kt[same] - pt[same]).max()) if same.any() else 0.0
    log(f'  {name}: hits {int(kh.sum())}/{len(kh)} agree {agree:.6f} '
        f'tri-equal {float(same.sum()) / max(int(both.sum()), 1):.6f} '
        f'max|dt| {err:.3e}')
    if agree < AGREE_MIN:
        raise RuntimeError(f'{name}: kernel and plain agree on {agree:.6f} '
                           f'< {AGREE_MIN}')
    return err


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: no CUDA device (torch.cuda.is_available() is '
                 'False)')
    sys.path.insert(0, REPO)
    from hydracore3_torch import render as R
    from hydracore3_torch.accel import traverse_dda as TDD
    from hydracore3_torch.accel import traverse_stream as TST
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
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
    build_s = TST.build_kernels()
    log(f'[1] kernels built from hydracore3_torch/csrc/traverse.cu in '
        f'{build_s:.2f} s')

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

    # ---- 3. kernels against the plain version, at the main path's shapes --
    # The queries of the render's first bounce, built by the integrator's
    # own functions on all 1,048,576 pixels: the camera rays' nearest hit,
    # the shadow rays' any-hit in the order the pass traces them, and the
    # sorted first-bounce rays' nearest hit.
    N = meta.width * meta.height
    woop = scene.st_woop
    stream = lambda *q, any_hit=False: TST.intersect_stream(  # noqa: E731
        scene.st_nodes_f, scene.st_nodes_i, woop, *q, any_hit=any_hit)
    march = lambda *q: TDD.intersect_march(  # noqa: E731
        scene.st_grid, woop, *q, with_unresolved=True)
    errs = {'intersect_stream': 0.0, 'intersect_march': 0.0}
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
        errs['intersect_march'] = max(errs['intersect_march'], compare(
            f'K3 intersect_march nearest, {label}', km, plain))
        ks = stream(*q)
        errs['intersect_stream'] = max(errs['intersect_stream'], compare(
            f'K2 intersect_stream nearest, {label}', ks, plain))
        log(f'  {label}: {int(live.sum())} live rays; plain {p_ms:.3f} ms')
        return q, km, ks, p_ms

    log(f'[3] kernels vs plain on the first bounce of the pass, {N} lanes')
    pix_all = torch.arange(N, device=dev)
    st = IPT.kernel_init_eye_ray(scene, meta, RNG.gen_init(pix_all), pix_all)
    cam_q, (mt, mtri, _, _), (wt, wtri, _, _), cam_plain_ms = check_nearest(
        'camera', st)

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
    plain, shadow_plain_ms = timed(lambda: TST.intersect_plain(
        woop, *shadow_q[:3], torch.clamp(shadow_q[3], max=0.99 * TST.FLT_MAX),
        any_hit=True))
    errs['intersect_stream'] = max(errs['intersect_stream'], compare(
        'K2 intersect_stream any-hit, shadow', stream(*shadow_q, any_hit=True),
        plain))
    log(f'  shadow: {int(rays.need_trace.sum())} traced rays, '
        f'{int((plain[1] >= 0).sum())} occluded; plain '
        f'{shadow_plain_ms:.3f} ms')

    # the first-bounce rays, sorted as trace_pass sorts them for bounce 1
    shade, rng2 = IPT.kernel_sample_light_source(scene, meta, st, ctx)
    st = IPT.kernel_next_bounce(scene, meta, st._replace(rng=rng2), 0, shade,
                                ctx)
    st, _ = IPT._sort_rays_for_trace(st, pix_all, scene.st_grid)
    bounce_q, _, _, bounce_plain_ms = check_nearest('bounce', st)
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
    im = img[..., :3].astype(np.float32)
    ds = im.reshape(128, meta.height // 128, 128, meta.width // 128,
                    3).mean((1, 3))
    mse = float(np.mean((ds - gold) ** 2))
    peak = max(float(gold.max()), 1e-9)
    psnr = 10.0 * np.log10(peak * peak / max(mse, 1e-20))
    mean_rel = abs(float(ds.mean()) / float(gold.mean()) - 1.0)
    log(f'  PSNR vs golden {psnr:.2f} dB; mean {float(ds.mean()):.6f} vs '
        f'golden {float(gold.mean()):.6f} ({100 * mean_rel:.3f}% off)')
    if psnr < PSNR_MIN or mean_rel > MEAN_TOL:
        raise RuntimeError(f'image off the golden: PSNR {psnr:.2f} dB, mean '
                           f'{100 * mean_rel:.3f}% off')

    src = 'hydracore3_torch/csrc/traverse.cu'
    replaces = {'intersect_stream': 'hydracore3_tpu/accel/traverse_stream.py:59',
                'intersect_march': 'hydracore3_tpu/accel/traverse_dda.py:563'}
    kernels = [dict(name=n, route='cuda', source=src, replaces=replaces[n],
                    launches=launches[n], max_abs_err=errs[n], ms=ms[n],
                    plain_ms=plain_ms[n]) for n in ('intersect_stream',
                                                 'intersect_march')]
    log(card)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
