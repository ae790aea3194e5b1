"""Render driver: pixel tiles x samples, framebuffer accumulation.

The counterpart of ``hydracore3_tpu/render.py``'s ``render``: the whole
spp budget runs tile by tile, each tile carrying its own per-pixel RNG
state, and the framebuffer is normalized by 1/spp.  RGB color layer only.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .ops import rng as RNG
from .models import integrator_pt as IPT

INTEGRATOR_BY_NAME = {'mispt': IPT.INTEGRATOR_MIS_PT}


def _one_sample(scene, meta, rng_state, pixel_ids, integrator_type):
    """One sample per pixel id; returns (contrib [N, 4], rng)."""
    accum, _, rng_state = IPT.trace_pass(scene, meta, rng_state, pixel_ids,
                                         integrator_type)
    return accum * scene.cam_response_rgb * meta.exposure_mult, rng_state


def render(scene, meta, spp: int = None, integrator: str = 'mispt',
           layer: str = 'color', tile_size: int = 1 << 15,
           return_timing: bool = False):
    """Render a full frame: float32 numpy [H, W, 4] (RGBA), normalized.

    With ``return_timing`` also returns dict(total_s, spp, rays, nonfinite),
    ``nonfinite`` counting lane samples with a non-finite contribution
    (nothing is scrubbed)."""
    if integrator not in INTEGRATOR_BY_NAME or layer != 'color':
        raise NotImplementedError(f'integrator={integrator!r}, '
                                  f'layer={layer!r} is not ported')
    spp = spp or meta.spp
    itype = INTEGRATOR_BY_NAME[integrator]
    dev = scene.proj_inv.device
    W, H = meta.width, meta.height
    N = W * H
    pixel_all = torch.arange(N, dtype=torch.int64, device=dev)
    rng_all = RNG.gen_init(pixel_all)
    tiles = [(s, min(s + tile_size, N)) for s in range(0, N, tile_size)]
    fb = [torch.zeros((e - s, 4), dtype=torch.float32, device=dev)
          for s, e in tiles]
    rngs = [rng_all[s:e] for s, e in tiles]
    nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for _ in range(spp):
        for k, (s, e) in enumerate(tiles):
            contrib, rngs[k] = _one_sample(scene, meta, rngs[k],
                                           pixel_all[s:e], itype)
            fb[k] += contrib
            nonfinite += (~torch.isfinite(contrib)).any(-1).sum()
    img = (torch.cat(fb).cpu().numpy() / np.float32(spp)).reshape(H, W, 4)
    total = time.perf_counter() - t0
    if return_timing:
        return img, dict(total_s=total, spp=spp, rays=N * spp,
                         nonfinite=int(nonfinite))
    return img
