"""The command line of the reference's main.cpp (user_guide.md:24-77), flag
for flag as ``hydracore3_tpu/cli.py`` has it.

Usage::

    python -m hydracore3_torch.cli -in scene.xml -out image.exr \\
        -integrator mispt -spp 256 [--cpu]

The scene goes to the CUDA card (``-gpu_id``, default 0) unless ``--cpu``
asks for the CPU; with neither a card nor ``--cpu`` the load raises.
``--gpu`` is accepted for parity; ``--debug-nojit`` too, and changes
nothing: the port runs eagerly already.  ``-profile DIR`` writes a
``torch.profiler`` trace of the render (``DIR/trace.json``, Chrome's
format).  After each render's ``PathTraceBlock(exec)`` line a
``KernelLaunches = {...}`` line gives, as JSON, each kernel wrapper's
launches in that render (a wrapper counts only where it launches its CUDA
kernel: on the CPU every count is 0).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser('hydracore3_torch', prefix_chars='-')
    p.add_argument('-in', dest='scene_in', required=True)
    p.add_argument('-out', dest='image_out', default='z_out.bmp')
    p.add_argument('-scn_dir', dest='scene_dir', default='')
    p.add_argument('-integrator', default='mispt',
                   choices=['naivept', 'shadowpt', 'mispt', 'all', 'raytracing',
                            'whitted_rt', 'prt', 'mlt'])
    p.add_argument('-spp', type=int, default=None)
    p.add_argument('-width', type=int, default=None)
    p.add_argument('-height', type=int, default=None)
    p.add_argument('-channels', type=int, default=4)
    p.add_argument('-gamma', type=float, default=2.2)
    p.add_argument('-fb_layer', default='color',
                   choices=['color', 'direct', 'indirect', 'direct_indirect'])
    p.add_argument('--spectral', action='store_true')
    p.add_argument('--regen', action='store_true',
                   help='persistent-lanes megakernel: lanes re-init dead '
                        'paths at once (mean-spp normalization)')
    p.add_argument('--qmc', action='store_true')
    p.add_argument('--cpu', action='store_true',
                   help='load and render on the CPU (default: the CUDA card)')
    p.add_argument('--gpu', action='store_true')   # accepted for parity
    p.add_argument('-gpu_id', type=int, default=0)
    p.add_argument('-cam_id', type=int, default=0)
    p.add_argument('-tile', type=int, default=1 << 17)
    p.add_argument('-look_at', nargs=16, type=float, default=None,
                   metavar='M', help='row-major 4x4 view matrix override')
    p.add_argument('-evalgbuffer', type=int, default=0,
                   help='render G-buffer layers instead of color')
    p.add_argument('-spp-naive-mul', dest='spp_naive_mul', type=int, default=1,
                   help='extra spp multiplier for the naive integrator')
    p.add_argument('-resource_dir', default='',
                   help='alias of -scn_dir (reference flag parity)')
    p.add_argument('-checkpoint', default='',
                   help='checkpoint path for pass-granular save/resume')
    p.add_argument('-checkpoint_every', type=int, default=8)
    p.add_argument('--resume', action='store_true',
                   help='resume an interrupted render from -checkpoint')
    p.add_argument('--debug-nojit', action='store_true', dest='debug_nojit',
                   help='accepted for parity; the port runs eagerly already')
    p.add_argument('-profile', default='',
                   help='write a torch.profiler trace of the render to this '
                        'directory')
    return p


def _kernel_wrappers():
    """The wrappers of the CUDA kernels a render may launch, each with
    its ``launches`` count."""
    from .accel import (traverse_dda, traverse_pallas, traverse_stream,
                        traverse_tlas, two_level)
    from .models import megakernel
    return (traverse_stream.intersect_stream, traverse_dda.intersect_march,
            traverse_dda.cell_pass, traverse_tlas.intersect_stream_tlas,
            traverse_pallas.intersect_clusters,
            traverse_pallas.intersect_clusters_motion, megakernel.sample_pass,
            megakernel.regen_pass, two_level.intersect_two_level)


def _eval_gbuffer(scene, meta, args):
    """-evalgbuffer: G-buffer layers to <stem>_<layer>.<ext> (main.cpp's
    G-buffer path, imageutils_gbuffer.cpp's exports)."""
    import torch
    from .models import gbuffer as GB
    from .utils import imageio as IIO
    t0 = time.time()
    N = meta.width * meta.height
    gb = GB.eval_gbuffer(scene, meta, torch.arange(
        N, dtype=torch.int64, device=scene.proj_inv.device))
    gb = gb._replace(**{f: v.cpu().numpy() for f, v in gb._asdict().items()})
    print(f'EvalGBuffer = {(time.time() - t0) * 1000.0:.2f} ms')
    H, W = meta.height, meta.width
    stem, dot, ext = args.image_out.rpartition('.')
    if not dot:
        stem, ext = args.image_out, 'bmp'

    def save(name, img):
        out = f'{stem}_{name}.{ext}'
        img = np.asarray(img).reshape(H, W, -1)[::-1]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        if out.endswith('.exr'):
            IIO.save_exr(out, img, 1.0)
        else:
            IIO.save_ldr(out, np.clip(img, 0, 1), 1.0, args.gamma)
        print(f'[main]: saved {out}')

    depth = gb.depth
    finite = np.isfinite(depth) & (depth < 1e30)
    dmax = depth[finite].max() if finite.any() else 1.0
    save('depth', np.where(finite, depth / max(dmax, 1e-9), 1.0)[:, None])
    save('normals', gb.norm * 0.5 + 0.5)
    save('texcoord', np.concatenate([gb.texc, np.zeros((N, 1), np.float32)],
                                    -1))
    save('texcolor', gb.rgba)
    save('coverage', gb.coverage[:, None])
    for name, ids in (('matid', gb.mat_id), ('objid', gb.obj_id),
                      ('instid', gb.inst_id)):
        ids = ids.astype(np.int64)
        # the reference's palette: ids hashed to stable colours
        img = np.stack([((ids * 2654435761) % 255) / 255.0,
                        ((ids * 805459861) % 255) / 255.0,
                        ((ids * 3674653429) % 255) / 255.0], -1)
        img[ids < 0] = 0.0
        save(name, img)
    return 0


def render_mlt_merged(scene, meta, spp, channels=4, progress=False,
                      n_chains=8192, tile_size=1 << 17):
    """``-integrator mlt``: split_direct_indirect (main.cpp:139-145,
    480-491), the direct layer by QMC MIS-PT (``tile_size`` lanes a
    dispatch: ``-tile``, whose default is ``render_qmc``'s), the indirect
    by Kelemen MLT chains, summed."""
    from . import render as R
    from .models import kmlt, integrator_pt as IPT
    direct = R.render_qmc(scene, meta, spp=spp, integrator='mispt',
                          layer='direct', channels=channels,
                          tile_size=tile_size, progress=progress)
    indirect = kmlt.render_mlt(scene, meta, spp=spp, n_chains=n_chains,
                               render_layer=IPT.FB_INDIRECT,
                               channels=channels, progress=progress)
    return direct + indirect


def _profiled(trace_dir):
    """A torch.profiler context writing ``trace_dir/trace.json`` at its
    end (nothing without a directory)."""
    if not trace_dir:
        return contextlib.nullcontext()
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)

    def write(prof):
        prof.export_chrome_trace(os.path.join(trace_dir, 'trace.json'))
    return torch.profiler.profile(activities=acts, on_trace_ready=write)


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch
    from .scene import build as SB
    from . import render as R
    from .utils import imageio as IIO

    if args.debug_nojit:
        print('[main]: --debug-nojit: the port runs op by op already; '
              'nothing changes')
    device = 'cpu' if args.cpu else (
        torch.device('cuda', args.gpu_id) if torch.cuda.is_available()
        else None)      # the loader raises: no card and no --cpu
    print(f'[main]: loading scene ... {args.scene_in}')
    if not os.path.exists(args.scene_in):
        print(f'[main]: ERROR, scene file not found: {args.scene_in}')
        return 1
    scene, meta = SB.load_scene(args.scene_in,
                                args.scene_dir or args.resource_dir,
                                spectral_mode=args.spectral,
                                width=args.width, height=args.height,
                                look_at_override=args.look_at,
                                cam_id=args.cam_id, device=device)
    spp = args.spp or meta.spp
    print(f'[main]: scene loaded: {meta.num_tris} tris, {meta.num_lights} '
          f'lights, {meta.num_materials} materials; {meta.width}x'
          f'{meta.height} @ {spp} spp')

    if args.evalgbuffer:
        return _eval_gbuffer(scene, meta, args)

    integrators = ([args.integrator] if args.integrator != 'all'
                   else ['naivept', 'shadowpt', 'mispt'])
    N = meta.width * meta.height
    pixels = torch.arange(N, dtype=torch.int64, device=scene.proj_inv.device)
    for integ in integrators:
        name = {'naivept': 'NaivePathTrace', 'shadowpt': 'PathTrace',
                'mispt': 'PathTrace', 'raytracing': 'RayTrace',
                'whitted_rt': 'RayTrace'}.get(integ, 'PathTrace')
        layer = args.fb_layer if args.fb_layer != 'direct_indirect' \
            else 'color'
        for w in _kernel_wrappers():
            w.launches = 0
        t0 = time.time()
        if integ in ('prt', 'raytracing', 'whitted_rt'):
            # primary rays only (CastSingleRay's flat colour), or Whitted
            from .models import integrator_rt as IRT
            fn = IRT.cast_single_ray if integ == 'prt' else IRT.ray_trace
            img = fn(scene, meta, pixels).cpu().numpy()
            img = img.reshape(meta.height, meta.width, 4)[..., :args.channels]
            timing = {'total_s': time.time() - t0}
        elif integ == 'mlt':
            img = render_mlt_merged(scene, meta, spp=spp,
                                    channels=args.channels, progress=True,
                                    tile_size=args.tile)
            timing = {'total_s': time.time() - t0}
        elif args.qmc:
            img, timing = R.render_qmc(scene, meta, spp=spp, integrator=integ,
                                       layer=layer, channels=args.channels,
                                       tile_size=args.tile, progress=True,
                                       return_timing=True)
        else:
            ispp = spp * (args.spp_naive_mul if integ == 'naivept' else 1)
            with _profiled(args.profile):
                img, timing = R.render(
                    scene, meta, spp=ispp, integrator=integ, layer=layer,
                    channels=args.channels, tile_size=args.tile,
                    progress=True, return_timing=True,
                    checkpoint_path=args.checkpoint or None,
                    checkpoint_every=args.checkpoint_every,
                    resume=args.resume, regen=args.regen)
            if args.profile:
                print(f'[main]: torch.profiler trace written to '
                      f'{args.profile}')
        ms = timing['total_s'] * 1000.0
        # the reference's timing lines, which run_bench-style regexes read
        tag = integ.upper() if integ == 'mispt' else integ
        print(f'{name}Block({tag}) = {ms:.2f} ms')
        print(f'PathTraceBlock(exec) = {ms:.2f} ms')
        print('KernelLaunches = ' + json.dumps(
            {w.__name__: w.launches for w in _kernel_wrappers()}))

        out = args.image_out
        if len(integrators) > 1:
            stem, dot, ext = out.rpartition('.')
            out = f'{stem}_{integ}.{ext}' if dot else f'{out}_{integ}'
        # flipped to display orientation: the framebuffer's row 0 is the
        # scene's bottom (the reference's BMP writer is bottom-up)
        img_disp = img[::-1]
        if out.endswith('.exr'):
            IIO.save_exr(out, img_disp, 1.0)
        else:
            IIO.save_ldr(out, img_disp, 1.0, args.gamma)
        print(f'[main]: saved {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
