"""Render driver: pixel tiles x samples, framebuffer accumulation.

The counterpart of ``hydracore3_tpu/render.py``'s ``render``.  Small scenes
(the JAX build's brute-traced class, fewer than 4096 triangles) go to the
megakernel (``models/megakernel.py``) when its gate admits them, as the JAX
router sends them on the TPU (``hydracore3_tpu/render.py:248-261``); on a
CUDA card that needs no switch.  The decision is made from the scene's
features before anything runs: a small scene the gate refuses (a blend,
plastic or thin film, an importance-sampled sky, more than 128 materials
or lights, depth above 12) goes to the batched integrator, which traces it
through the cluster kernel over its rows; a scene the gate admits whose
kernel fails to build or launch raises.  Streamed, two-level
(``meta.use_stream_tlas``) and mid-size (``meta.use_pallas``) scenes run
the batched integrator (``mispt``, ``shadowpt`` or ``naivept``): the whole
spp budget tile by tile, each tile carrying its own per-pixel RNG state,
the framebuffer normalized by 1/spp.  So do scenes with a moving instance
(two-level, ``meta.use_two_level``) and the ``direct`` and ``indirect``
layers on every scene class, which the megakernel never takes
(``hydracore3_tpu/render.py:254``).

``render_qmc`` (the Niederreiter sampler, IntegratorQMC) always runs the
batched integrator, as the JAX package's does; so does a render that
checkpoints or resumes (``checkpoint_path``, ``checkpoint_every``,
``resume``), whose per-tile framebuffers and RNG rows the checkpoint
holds in the JAX package's tile layout, so that a render either package
checkpointed can be finished by the other.

A spectral scene's sample converts to RGB as the JAX render's does
(kernel_ContributeToImage, integrator_pt.cpp:598-657): through the CIE
curves with the terminated-waves rule, or through the camera's measured
response spectra; or it fills an N-channel spectral framebuffer
(``channels`` > 4), which the megakernel never takes.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .ops import qmc as QMC
from .ops import rng as RNG
from .ops import spectrum as SPEC
from .bsdf import common as C
from .models import integrator_pt as IPT
from .models import megakernel as MK
from .models.integrator_pt import INTEGRATOR_BY_NAME
from .utils.spans import span

LAYER_BY_NAME = {'color': IPT.FB_COLOR, 'direct': IPT.FB_DIRECT,
                 'indirect': IPT.FB_INDIRECT}


def contribution(scene, meta, accum, wavelengths, flags, channels: int = 4):
    """A sample's framebuffer contribution [N, channels] from its radiance
    ``accum`` [N, 4] (``_one_sample``, hydracore3_tpu/render.py:40-95):
    one channel; an N-channel spectral framebuffer, each hero lane added
    into its wavelength band's channel; in spectral mode RGB through the
    measured response spectra (Y falls back to X and Z to Y; an XYZ
    response converts to RGB) or the CIE curves, alpha 1; in RGB mode the
    camera's RGB response.  ``wavelengths`` is None in RGB mode."""
    if wavelengths is None:
        wavelengths = torch.zeros_like(accum)
    if channels == 1:
        return accum[..., :1] * meta.exposure_mult
    if channels > 4:
        t = ((wavelengths - SPEC.LAMBDA_MIN)
             / (SPEC.LAMBDA_MAX - SPEC.LAMBDA_MIN))
        ch = torch.clamp((t * channels).to(torch.int64), max=channels - 1)
        # a negative band counts from the end, as a JAX index does
        ch = torch.where(ch < 0, ch + channels, ch)
        out = torch.zeros(accum.shape[:-1] + (channels,), dtype=accum.dtype,
                          device=accum.device)
        return out.scatter_add_(-1, ch, accum * meta.exposure_mult)
    if meta.spectral_mode:
        if meta.has_cam_response_spectra:
            ids = scene.cam_response_spec_id
            S = scene.spec_offset_sz.shape[0]

            def resp(i, fallback):
                off = scene.spec_offset_sz[torch.clamp(ids[i], 0, S - 1), 0]
                r = SPEC.sample_uniform_spectrum(
                    scene.spec_values, off.expand(wavelengths.shape[:-1]),
                    wavelengths)
                return torch.where(ids[i] >= 0, r, fallback)

            rx = resp(0, torch.ones_like(wavelengths))
            ry = resp(1, rx)
            rz = resp(2, ry)
            xyz = torch.stack([(accum * rx).sum(-1), (accum * ry).sum(-1),
                               (accum * rz).sum(-1)], dim=-1)
            rgb = SPEC.xyz_to_rgb(xyz) if meta.cam_response_type == 0 \
                else xyz
        else:
            terminate = (flags & C.RAY_FLAG_WAVES_DIVERGED) != 0
            rgb = SPEC.xyz_to_rgb(SPEC.spectrum_to_xyz(
                accum, wavelengths, scene.cie_xyz, terminate))
        return torch.cat([rgb * meta.exposure_mult,
                          torch.ones_like(rgb[..., :1])], -1)[..., :channels]
    return (accum * scene.cam_response_rgb
            * meta.exposure_mult)[..., :channels]


def _one_sample(scene, meta, rng_state, pixel_ids, integrator_type,
                channels: int = 4, render_layer: int = IPT.FB_COLOR,
                qmc_ctx=None):
    """One sample per pixel id; returns (contrib [N, channels], rng, the
    lanes' output pixel ids: ``pixel_ids``, or under a QMC or MLT context
    (``IPT.trace_pass_state``) the pixels the samples landed on)."""
    with span('hc3.pass'):
        st = IPT.trace_pass_state(scene, meta, rng_state, pixel_ids,
                                  integrator_type, render_layer, qmc_ctx)
        return (contribution(scene, meta, st.accum_color, st.wavelengths,
                             st.flags, channels), st.rng,
                pixel_ids if st.pixel is None else st.pixel)


def _check_args(integrator, layer):
    if layer not in LAYER_BY_NAME:
        raise NotImplementedError(f'layer={layer!r} (color, direct, '
                                  'indirect)')
    if integrator not in INTEGRATOR_BY_NAME:
        raise NotImplementedError(f'integrator={integrator!r} is not ported')


def _nonfinite(contrib):
    return (~torch.isfinite(contrib)).any(-1).sum()


def _progress(on, done, total, tag=''):
    if on:
        print(f'rendering{tag}, progress = {100.0 * done / total:.2f} %',
              end='\r', flush=True)


def use_megakernel(scene, meta, integrator: str = 'mispt',
                   channels: int = 4, layer: str = 'color') -> bool:
    """The router: a small scene (none of the three cluster-BVH classes)
    whose features the megakernel's gate admits goes to the megakernel
    when the framebuffer has 4 channels and the layer is the color one
    (hydracore3_tpu/render.py:254); every other scene to the batched
    integrator."""
    small = not (meta.use_stream or meta.use_stream_tlas or meta.use_pallas)
    return (small and channels == 4 and layer == 'color'
            and MK.supported(scene, meta, integrator))


def _qmc_dims(meta):
    """EnableQMC's dimensions (mlt/integrator_qmc.cpp:28-86): (spd_dim,
    mat_dim, lgt_dim), 0 where the pseudo RNG serves; dimensions 0/1 are
    always the pixel position, 2/3 the lens when the thin lens or the lens
    stack is on (both reserve them; only the thin lens reads them, as in
    the JAX package).  The shutter time takes no dimension: its draw is
    always the pseudo RNG's; motion only shifts the others."""
    dof = meta.cam_lens_radius > 0.0 or len(meta.lens_lines) > 0
    spd = meta.spectral_mode
    motion = meta.has_motion
    if dof and spd and motion:
        return 4, 0, 0
    if dof and spd:
        return 4, 5, 7
    if spd and motion:
        return 3, 4, 6
    if dof and motion:
        return 0, 5, 7
    if dof:
        return 0, 4, 6
    if spd:
        return 4, 2, 5
    if motion:
        return 0, 2, 5
    return 0, 2, 4


def render_qmc(scene, meta, spp: int = None, integrator: str = 'mispt',
               layer: str = 'color', channels: int = 4,
               tile_size: int = 1 << 17, progress: bool = False,
               return_timing: bool = False):
    """QMC render, IntegratorQMC::PathTraceBlock
    (mlt/integrator_qmc.cpp:284-315; JAX ``render.render_qmc``): always
    the batched integrator.  A pass runs ``n_tiles = ceil(N / tile)``
    tiles of ``tile = min(tile_size, N)`` lanes, each tile with its own
    RNG rows (``gen_init`` of its lane ids) and sample indices ``arange
    (tile) + sample_base``, ``sample_base`` growing by ``tile`` a tile;
    the samples' pixels come from QMC dimensions 0/1 and their
    contributions are scatter-added there (``index_add_``, the reference's
    atomics), so a pass draws ``n_tiles * tile`` samples over the whole
    frame.  The framebuffer is divided by ``spp``.  Returns float32 numpy
    [H, W, channels]; with ``return_timing`` also dict(total_s, spp,
    samples, nonfinite), whose ``samples`` are the ``n_tiles * tile * spp``
    drawn."""
    _check_args(integrator, layer)
    with span('hc3.render'):
        spp = spp or meta.spp
        itype = INTEGRATOR_BY_NAME[integrator]
        rlayer = LAYER_BY_NAME[layer]
        dev = scene.proj_inv.device
        W, H = meta.width, meta.height
        N = W * H
        spd_dim, mat_dim, lgt_dim = _qmc_dims(meta)
        table = QMC.qmc_table(dev)
        n_tiles = -(-N // tile_size)
        tile = min(tile_size, N)
        pixel_ids = torch.zeros(tile, dtype=torch.int64, device=dev)  # unused
        lanes = torch.arange(tile, dtype=torch.int64, device=dev)
        rngs = [RNG.gen_init(lanes + t * tile) for t in range(n_tiles)]
        fb = torch.zeros((N, channels), dtype=torch.float32, device=dev)
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        sample_base = 0
        for p in range(spp):
            for t in range(n_tiles):
                ctx = dict(table=table, idx=lanes + sample_base,
                           spd_dim=spd_dim, mat_dim=mat_dim, lgt_dim=lgt_dim)
                contrib, rngs[t], out_px = _one_sample(
                    scene, meta, rngs[t], pixel_ids, itype, channels, rlayer,
                    ctx)
                fb.index_add_(0, out_px, contrib)
                nonfinite += _nonfinite(contrib)
                sample_base += tile
            _progress(progress, p + 1, spp)
        if progress:
            print()
        with span('hc3.sync.readback'):
            img = (fb.cpu().numpy() / np.float32(spp)).reshape(H, W, channels)
        total = time.perf_counter() - t0
        if return_timing:
            return img, dict(total_s=total, spp=spp, samples=sample_base,
                             nonfinite=int(nonfinite))
        return img


def _load_tiles(path, fb, rngs):
    """The checkpoint at ``path`` into the tiles' framebuffers and RNG
    rows (the JAX layout: fb tiles f32, then RNG tiles u32); returns the
    samples it holds."""
    from .utils import checkpoint as CKPT
    (fb_l, rng_l), done, _ = CKPT.load_checkpoint(path, like=(fb, rngs))
    shapes = [tuple(x.shape) for x in fb + rngs]
    if [tuple(x.shape) for x in list(fb_l) + list(rng_l)] != shapes:
        raise ValueError(f'checkpoint {path} holds other tiles than this '
                         f'render\'s ({len(fb)} of {tuple(fb[0].shape)})')
    dev = fb[0].device
    for k in range(len(fb)):
        fb[k] = torch.from_numpy(np.asarray(fb_l[k], np.float32)).to(dev)
        rngs[k] = torch.from_numpy(
            np.asarray(rng_l[k]).astype(np.int64)).to(dev)
    return done


def render(scene, meta, spp: int = None, integrator: str = 'mispt',
           layer: str = 'color', channels: int = 4, tile_size: int = 1 << 15,
           return_timing: bool = False, regen: bool = False,
           progress: bool = False, checkpoint_path: str = None,
           checkpoint_every: int = 0, resume: bool = False):
    """Render a full frame: float32 numpy [H, W, channels] (RGBA by
    default; ``contribution`` says what other counts hold), normalized.

    ``regen`` is the megakernel's (persistent lanes) and is ignored on
    the batched integrator's scenes, as the JAX router ignores it there.
    With ``return_timing`` also returns the timing dict: on the batched
    route dict(total_s, spp, samples, nonfinite), ``samples`` being
    W x H x spp, on the megakernel's ``MK.render``'s; ``nonfinite`` counts
    lane samples with a non-finite contribution (nothing is scrubbed).

    With ``checkpoint_path`` and ``checkpoint_every=K`` the per-tile
    framebuffers, RNG rows and the samples done are saved every K samples
    (``utils/checkpoint.py``); ``resume`` continues from that file when it
    exists (JAX ``render.py``:225-330).  Both send every scene to the
    batched integrator and lay the frame out as JAX does: ``tile_size``
    tiles, the last padded with lanes of pixel 0 and RNG rows 0, whose
    samples are dropped."""
    _check_args(integrator, layer)
    with span('hc3.render'):
        ckpt = bool(checkpoint_path and checkpoint_every)
        padded = ckpt or resume
        if not padded and use_megakernel(scene, meta, integrator, channels,
                                         layer):
            return MK.render(scene, meta, spp=spp, integrator=integrator,
                             regen=regen, return_timing=return_timing)
        spp = spp or meta.spp
        itype = INTEGRATOR_BY_NAME[integrator]
        dev = scene.proj_inv.device
        W, H = meta.width, meta.height
        N = W * H
        pixel_all = torch.arange(N, dtype=torch.int64, device=dev)
        rng_all = RNG.gen_init(pixel_all)
        if padded:
            n_pad = -(-N // tile_size) * tile_size - N
            pixel_all = torch.cat([pixel_all,
                                   torch.zeros_like(pixel_all[:n_pad])])
            rng_all = torch.cat([rng_all, torch.zeros_like(rng_all[:n_pad])])
        tiles = [(s, min(s + tile_size, pixel_all.shape[0]))
                 for s in range(0, N, tile_size)]
        fb = [torch.zeros((e - s, channels), dtype=torch.float32, device=dev)
              for s, e in tiles]
        rngs = [rng_all[s:e] for s, e in tiles]
        done = 0
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            done = _load_tiles(checkpoint_path, fb, rngs)
        nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        t0 = time.perf_counter()
        for p in range(max(spp - done, 0)):
            for k, (s, e) in enumerate(tiles):
                contrib, rngs[k], _ = _one_sample(
                    scene, meta, rngs[k], pixel_all[s:e], itype, channels,
                    LAYER_BY_NAME[layer])
                fb[k] += contrib
                nonfinite += _nonfinite(contrib[:N - s])
            if ckpt and (p + 1) % checkpoint_every == 0:
                from .utils import checkpoint as CKPT
                CKPT.save_checkpoint(
                    checkpoint_path, ([f.cpu().numpy() for f in fb],
                                      [r.cpu().numpy().astype(np.uint32)
                                       for r in rngs]), step=done + p + 1)
            _progress(progress, done + p + 1, spp)
        if progress:
            print()
        with span('hc3.sync.readback'):
            img = (torch.cat(fb)[:N].cpu().numpy()
                   / np.float32(spp)).reshape(H, W, channels)
        total = time.perf_counter() - t0
        if return_timing:
            return img, dict(total_s=total, spp=spp, samples=N * spp,
                             nonfinite=int(nonfinite))
        return img
