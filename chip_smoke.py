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
     per ray and the bound they set; ``render.render`` at RATE_SPP
     (cut from 16 to make room for phase 20); the same city flattened
     (``accel='stream'``, K2/K3) at RATE_SPP with the same seeds: PSNR >= 35 dB, means within 2%, the share of pixels
     equal to 1e-3, the device memory of both builds (the contract tables
     and the kernel's wide tables apart); and the 48-block
     instanced city built under ``accel='auto'`` (must go two-level);
  7. the mid-size city (``scene.synth.city_scene(n_blocks=40, width=1024,
     height=1024, depth=5, textured=True)``, 152,194 triangles, routed to
     the cluster kernel K5 by ``'auto'``): the kernel against its plain
     version on the same three queries (unsorted), each with its time,
     counts per ray and bound: every lane's hit flag, and for a nearest
     hit its triangle, t, u and v, must equal the plain version's (K5's
     test rounds op by op as the plain version's); under any-hit the
     kernel reports the first occluder its walk meets and the plain
     version the lowest, so the reported triangle is tested against its
     lane's ray with the plain Moller-Trumbore arithmetic and must be valid
     on every occluded lane;
     ``render.render`` at RATE_SPP, and the same scene streamed at
     RATE_SPP (both cut from 16 to make room for phase 20): PSNR >= 35 dB,
     means within 2%;
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
     city beside the card's name and power limit;
  10. the material zoo box (tests/zoo_scenes.py: the textured box plus a
     rough and a smooth conductor, a Lambert and an Oren-Nayar diffuse, a
     dielectric cube, an old-Hydra glass cube, a disc light and an 8-bit
     lat-long sky; 1024x768, depth 6) through K1 for ``naivept``,
     ``shadowpt`` and ``mispt``, each through its own kernel variant
     (integrator, material set, env tap) with its registers and local
     bytes: both entry points against the plain version on every lane of
     a full frame, timed with the counting build's Woop tests, child-box
     tests and shades by material kind and the bound they set; renders at
     64 spp (fixed chain and ``regen``) with their launches, Msamples/s, 0
     non-finite lane samples, PSNR and mean against
     ``tests/goldens/zoo_box_<integrator>_128.npz`` (>= 35 dB and 2%,
     ``naivept`` >= 30 dB and 5%), regen against the fixed chain and the
     fixed chain against the same box on the batched streamed route
     (``accel='stream'``, K2/K3) at 16 spp, both >= 30 dB on 8x box means;
  11. the zoo city (the bench city, its walls an Oren-Nayar diffuse, a
     rough conductor, a dielectric and a glass): K2 and K3 against the
     dense plain version on every lane of its sorted first-bounce
     (refracted lanes among them) and shadow queries (its camera query is
     phase 3's), and each
     integrator's render (``mispt`` at 16 spp, the others at RATE_SPP since
     PR 15) with its launches, Msamples/s and 0 non-finite lane samples,
     ``mispt`` against ``tests/goldens/zoo_city_mispt_128.npz``;
  12. the zoo box II (tests/zoo_scenes.py: the zoo box's shell with a rough
     and a smooth nonlinear plastic, a transparent, a rough metal-substrate
     (one layer's eta an SPD file) and a thickness-mapped thin film, a
     blend of a blend and a float-textured sky; 1024x768, depth 6), which
     K1 refuses and ``'auto'`` therefore sends to the batched integrator,
     traced through K5 over the small class's rows (``scene.cl_wide``):
     K5 equal to its plain version on every lane of the camera, bounce-0
     shadow and first-bounce queries, each timed, counted and bounded as in
     phase 7; each integrator's render (``mispt`` at 16 spp, ``naivept``
     and ``shadowpt`` at RATE_SPP, cut from 16 in PR 15 to make room for
     phase 19) with 0 K1 launches, its K5 launches, Msamples/s and 0
     non-finite lane samples, logged against
     ``tests/goldens/zoo_box2_<integrator>_128.npz``; the same box at the
     golden's size and seeds for the golden's first 16 samples (its
     ``early`` image), >= 60 dB; the streamed twin (``accel='stream'``,
     K2/K3) of the ``mispt`` render, >= 35 dB against it;
  13. the zoo city II (the bench city, its walls a textured Oren-Nayar
     diffuse, a rough plastic, a rough metal-substrate thin film and a
     blend): K2 and K3 against the dense plain version on every lane of its
     sorted first-bounce and shadow queries, its ``mispt`` render at the
     golden's size, samples and seeds (``tests/goldens/
     zoo_city2_mispt_128.npz``, >= 60 dB) and at full size, 4 spp;
  14. the spectral box (tests/zoo_scenes.py ``write_spectral_box``: SPD
     Lambert and Oren-Nayar diffuses, gold-like rough and smooth
     conductors, the textured GLTF quad and walls, a blackbody rect light,
     a flat sky with an SPD; loaded with ``spectral_mode=True``; 1024x768,
     depth 6) through K1's spectral variant (``-DHC3_SPECTRAL=1``) for each
     integrator, as phase 10: both entry points against the plain version
     on every lane, timed with the counting build and bounded, the
     variant's registers and local bytes, renders at 64 spp (fixed chain
     and ``regen``) with launches, Msamples/s, 0 non-finite samples and
     phase 10's bars against ``tests/goldens/spec_box_<integrator>_
     128.npz`` (``naivept``: its mean; its PSNR is the golden's noise),
     regen against the fixed chain, and a render at the golden's size,
     samples and seeds, which follows its random streams, >= 60 dB;
  15. the spectral box II (``write_spectral_box(k1=False)``: a dielectric
     with a Cauchy IOR SPD, a glass, a spectral-texture diffuse, two thin
     films, a blend, a float sky with an SPD, XYZ response spectra), which
     K1 refuses: its ``mispt`` render at 16 spp through K5 with 0 K1
     launches, and at the golden's size and seeds for its first 16 samples
     the RGB image and the 16-channel spectral framebuffer against
     ``tests/goldens/spec_box2_mispt_128.npz`` (``early``) and
     ``spec_box2_16ch_early.npz``, >= 60 dB each.
  16. the feature box (tests/zoo_scenes.py ``write_feature_box``: a spot
     light, a point and a rect light with IES profiles, normal-mapped GLTF,
     conductor and blend leaf, GLTF slot-2/3 maps split and packed, a
     camera-back texture; 1024x768, depth 6), which K1 refuses, for each of
     its cameras (pinhole, thin lens, lens stack): K5 equal to its plain
     version on every lane of the pinhole camera's camera, bounce-0 shadow
     and first-bounce queries and of the lens stack's camera query (its
     failed rays, started far below the scene, among them), and K3 and K2
     on that query of the box streamed; a ``mispt`` render with 0 K1
     launches, its K5 launches, Msamples/s and 0 non-finite samples (the
     pinhole one at 16 spp, >= 35 dB and mean within 2% against
     ``tests/goldens/feat_box_pinhole_mispt_128.npz``; the thin lens's and
     the lens stack's at RATE_SPP, cut from 16 in PR 15 to make room
     for phase 19: no golden holds their full frames); at each golden's
     size and seeds its first 16 samples (the spectral box's too) >= 60 dB;
     the eager ops of one pass; the feature city (the bench city with a
     spot, an IES light and normal-mapped walls; K2/K3): K2 and K3 against
     the dense plain version on every lane of its camera and first-bounce
     queries (the camera query's plain answer is phase 3's where the two
     queries are equal bit for bit), a ``mispt`` render at 16 spp and at
     the golden's size, samples and seeds >= 60 dB.
  17. motion blur, Whitted, the G-buffer and the layers: the motion box
     and the motion city (tests/zoo_scenes.py ``write_motion_box``,
     ``write_motion_city``: a moving cube in the textured box; every 8th
     block of the instanced city moving) loaded under ``'auto'``, which
     must route them two-level by time, past K1; K4's motion variant's
     registers and local bytes; its camera, shadow and first-bounce queries
     at the lanes' shutter times against its plain version, every lane of
     the box and the city's first TESS_LANES lanes (hit flag, triangle,
     instance, t, u, v; any-hit: the reported pair occludes), each timed at
     full width with its counted tests, instance entries and bound; both
     scenes' ``mispt`` renders at 16 spp (K4m launches, 0 K1 launches, 0
     non-finite samples) and at their golden's size and seeds against its
     first 16 samples (>= 60 dB and 99.9% of the pixels within 1e-3);
     ``cast_single_ray``, ``ray_trace`` and
     ``eval_gbuffer`` at full frame on the textured box (K5) and the bench
     city (K3/K2) with their launches and wall seconds, and at the
     deterministic goldens' size against them (tests/goldens/rt_box_256.npz,
     rt_city_128.npz); the box's ``direct`` and ``indirect`` layers at
     RATE_SPP (16 before PR 15) on the batched route (K5).
  18. the QMC and Kelemen-MLT samplers, checkpoint / resume and the
     command line, on the batched route (K5 for the box, K3/K2 for the
     bench city; 0 K1 launches, 0 non-finite samples): ``render_qmc`` of
     the textured box and the bench city at 16 spp (the box through K5
     though K1 admits it: QMC always runs the batched integrator), each
     against its golden (tests/goldens/box_1024x768_128.npz,
     city_bench_128.npz: PSNR >= 35 dB, mean within 2%) and at the QMC
     goldens' size and seeds (tests/goldens/qmc_box_mispt_128.npz,
     qmc_city_mispt_128.npz: >= 60 dB and 99.9% of the pixels within
     1e-3); ``models/kmlt.render_mlt`` (the colour layer) and the CLI's
     merged ``-integrator mlt`` image (QMC direct plus MLT indirect) of the
     box with MLT_CHAINS chains, each mean within 2% of phase 5's ``mispt``
     image, and both at the MLT golden's size and seeds against
     tests/goldens/mlt_box_128.npz (>= 60 dB and 99.9% of the pixels
     within 1e-3, the bar the CPU port's run sets; means within 2%); the
     bench city's render
     checkpointed every 4 samples, stopped after 8 and resumed to 16,
     each half through K3/K2 alone, equal bit for bit to phase 4's
     uninterrupted image; ``python -m hydracore3_torch.cli`` as a
     subprocess on phase 9's city library, exit 0 with the reference's
     timing line and its own launch counts (its ``KernelLaunches`` line:
     K3 and K2 and no other kernel), its EXR read back equal bit for bit
     to ``render.render``'s image of the library loaded here;
  19. differentiable rendering (``models/dr.py``) on the DR box
     (``zoo_scenes.write_dr_box``: the textured box with a 256 x 256
     back-wall texture, drmain's trainable slot) at 512 x 512, depth 6,
     always on the batched route (K5): K5 on its camera and first-bounce
     queries equal to the plain version on every lane and the hit's
     backward (``accel/hit_grad.py``) within 1e-4 of the plain version's
     autograd gradient; (a) ``loss_and_grad`` at 1.0 (finite, the texels
     it reaches, K5's launches); (b) the texels' directional derivative
     against central differences (eps 1e-3, f64 sums) within 5%; (c)
     ``mat_loss_and_grad`` on the back wall's red against central
     differences within 5%, and on the zoo box's glass IOR (512 x 384),
     whose loss jumps where a Fresnel choice, a total internal reflection
     or an edge flips, over the lanes whose loss is smooth on the step
     (``zoo_scenes.smooth_lanes``) within 5%: this runs the hit's backward
     on the card; (d) ``whitted_loss_and_grad`` finite and non-zero; (e)
     ``optimize_texture`` for DR_ITERS iterations against a 16-spp target
     (JAX's bars for drmain's configuration: the last loss below 0.97 x
     the first, the least among the last half; whether the losses never
     rise is printed), one
     iteration's forward and backward timed and their eager ops counted,
     the peak device memory; (f) at the DR goldens' size and seeds
     (tests/goldens/dr_box_128.npz, dr_box_ior_128.npz): loss within 1e-4,
     the texel gradient's relative L2 error within 1e-2, the losses of
     their optimize_texture iterations within 1e-4, the glass IOR's loss
     within 1e-4 and its gradient finite (JAX's is NaN there, ROADMAP.md
     section 3).  The camera plugin (``camera_plugin.py``):
     ``match_scene_camera`` renders of the box (1024 x 768, three tiles
     that repeat tile 0's streams, as JAX's do; K5) and of the bench city
     (K3/K2, unsorted) at 16 spp against their goldens (>= 35 dB, mean
     within 2%), the box at the plugin golden's size and seeds
     (tests/goldens/plugin_box_128.npz, >= 60 dB), the table-lens camera's
     share of rays through its stack and a finite image;
  20. data parallelism (``parallel/mesh.py``), the ray count and the hit's
     gradient on the two-level classes: (a) ``init_distributed()`` from
     torchrun's variables (127.0.0.1, a free port, world size 1, rank 0):
     the NCCL backend and one right ``all_reduce``; (b) ``render_sharded``
     of the bench city (16 spp, tiles of 1,048,576 lanes) equal to phase
     4's image bit for bit with phase 4's K3 and K2 launches, its seconds
     and Msamples/s beside phase 4's; (c) ``sharded_train_step`` on the DR
     box at 512 x 512 equal to ``dr.loss_and_grad``'s loss and gradient bit
     for bit (both under torch's deterministic algorithms), 12 K5 launches;
     (d) ``count_rays_pass`` of the bench city, one pass through K3/K2: its
     nearest-hit and shadow rays and Mrays/s over phase 4's render time;
     (e) rays that autograd tracks through K4 (the instanced city's camera
     query; its plain walk on the first 65,536 lanes) and K4m (the motion
     box's camera, shadow and bounce rays): hits equal to the plain walk's
     and the backward within 1e-4 of the plain walk's autograd gradient on
     99.9% of the lanes.  The process group is destroyed at the phase's
     end;
  21. the flattened-soup route with per-triangle motion: phase 17's motion
     box and motion city built under ``accel='bvh'`` (one soup, each
     triangle with its change over the shutter, never two-level), traced
     at each ray's time through the cluster kernel's moving variant (K5m,
     ``intersect_clusters_motion``): K5m on every lane of the box's camera,
     shadow and first-bounce queries and on the city's camera query (its
     plain version on the first TESS_LANES lanes), each timed at full
     width with its counted box and Moller-Trumbore tests (x MT_OPS +
     LERP_OPS) and bound, its registers; both full-frame moving soups at
     RATE_SPP against their two-level twins (``'auto'``, K4m) at the same
     seeds, >= SOUP_TWIN_PSNR and means within SOUP_TWIN_MEAN, with K5m's
     launches and 0 of K1; the box at the golden's size and seeds
     (tests/goldens/soup_motion_box_mispt_128.npz, JAX ``'bvh'``, its first
     16 samples): >= 60 dB and MOTION_SEED_PIXELS of the pixels.
  Phases 10-21 record a missed check and fail the run after every phase
  has run, as the equal-t ties of phase 3 do.
Every kernel's ``bound_ms`` is the larger of its bytes (rays and outputs
once, each table once) over 3.35 TB/s and its operations over 67 TFLOP/s
(f32 outside the tensor cores); the ray-query kernels' operations are
counted by a second build of csrc/traverse.cu (``-DHC3_COUNT``, loaded by
this script alone) run on the very query that is timed: what this kernel's
own walk did, not the least a query needs
(child-box tests x 25, Woop tests x 45 or Moller-Trumbore tests x 52, instance
entries x 36, or x 242 in K4's motion variant, grid cells x 20
operations); K1's by a second build of
csrc/megakernel.cu (``-DHC3_COUNT``, likewise) on the timed pass and launch
(Woop tests x 45, child-box tests x 25, shades x SHADE_OPS of their
material kind, less NEE_OPS under the naive integrator; K1 is built
without FMA contraction, so its attainable rate is half of 67 TFLOP/s,
which its line also prints; the bound keeps the table's convention; the
spectral variant's shades add SPEC_SHADE_EXTRA and each lane
SPEC_SAMPLE_OPS).  No single PyTorch call computes a ray query or a
path-traced sample, so ``library_ms`` is null throughout; K1's entries
also carry the zoo box's figures per integrator (``zoo_box``), and its
spectral variant has entries of its own (``mega_sample_spectral``,
``mega_regen_spectral``: the spectral box's ``mispt`` figures and the
launches of its renders, the other integrators' under ``spectral_box``).
K4's motion variant (``intersect_tlas_motion``, replacing the XLA walk of
hydracore3_tpu/accel/two_level.py) carries the motion box's figures and
the motion city's (``motion_box``, ``motion_city``); K5's entry Whitted's,
the G-buffer's and the layers' (``whitted_gbuffer_layers``) and
differentiable rendering's and the plugin box's (``dr_plugin_box``); K2's
and K3's the plugin city's (``plugin_city``).  K5's moving-soup variant
(``intersect_clusters_motion``, replacing the XLA traces of a moving soup,
hydracore3_tpu/accel/traverse.py ``intersect_brute`` and its kin with
``motion=``) carries phase 21's motion box and motion city
(``motion_box``, ``motion_city``); its launches are the full-frame moving
soups' renders.  Phase 20's launches add to
the K2, K3, K4, K5 and K4m entries' counts, and its figures stand in
``data_parallel_city`` and ``count_rays_pass`` (K2, K3),
``data_parallel_dr`` (K5) and ``two_level_grad`` (K4, K4m).
The kernel sources (csrc/traverse.cu with csrc/traverse_wide.cuh, which
holds K2-K5, K4's motion variant and K5's, csrc/megakernel.cu in its seven
variants, and the counting build of each) build in parallel in phase 1.
To make room for phase 19, PR 15 cut eight full-frame renders that no
golden holds from 16 spp to RATE_SPP (phases 11 and 12's ``naivept`` and
``shadowpt``, phase 16's thin lens and lens stack, phase 17's direct and
indirect layers); to make room for phase 20, four more were cut (phase
6's two-level and flattened instanced city, phase 7's cluster-route and
streamed mid-size city; the K4 and K5 lines' counts drop by their share);
no check was cut.  The line before the last is a JSON record of the
kernels;
the last line is ``{"ok": true, "device": {...}}``.  Needs no JAX and no
network.
"""
import concurrent.futures
import contextlib
import dataclasses
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
# phase 10: the zoo box's integrators, their bars against the JAX goldens
# (PSNR dB, relative mean error); the naive one converges slowest
ZOO_INT = ('naivept', 'shadowpt', 'mispt')
ZOO_PSNR = {'naivept': 30.0, 'shadowpt': 35.0, 'mispt': 35.0}
ZOO_MEAN = {'naivept': 0.05, 'shadowpt': 0.02, 'mispt': 0.02}
ZOO_TWIN_SPP = 16      # the batched streamed twin of the zoo box
# phase 11: the zoo city's mispt render against its JAX golden, which the
# CPU renders at 128 x 128 with 4 samples per pixel (4 per 8 x 8 block of
# the full frame).  The full frame's bar is set by the golden's own noise;
# a render at the golden's size, samples and seeds follows the same random
# streams and is held tightly
CITY_ZOO_PSNR = 25.0
CITY_ZOO_MEAN = 0.05
CITY_ZOO_SMALL_PSNR = 60.0
CITY_ZOO_SMALL_MEAN = 1e-3
# phase 13: the zoo city II's full-size render (its rate; the golden's
# size carries the check)
CITY2_SPP = 4
# phase 14: the spectral box through K1's spectral variant, its full frame
# at 64 spp against the 1,024-sample goldens (the naive integrator's
# PSNR there is the golden's own noise, 26-27 dB: its mean is held, and
# its image by the render at the golden's size, samples and seeds, which
# follows the golden's random streams, SPEC_SEED_PSNR); phase 15: the
# spectral box II on the batched route, its N-channel framebuffer's
# channels
SPEC_PSNR = {'shadowpt': 35.0, 'mispt': 35.0}
SPEC_MEAN = ZOO_MEAN
SPEC_SEED_PSNR = 60.0
SPEC_CHANNELS = 16
# phase 16: the feature scenes' renders, 16 spp (a full frame's 8 x 8
# block then holds as many samples as the 1,024-sample golden's pixel)
FEAT_SPP = 16
# full-frame renders that no golden holds (phases 11 and 12's naivept and
# shadowpt, phase 16's thin lens and lens stack, phase 17's direct and
# indirect layers, cut from 16 spp to make room for phase 19; phase 6's
# two-level and flattened instanced city and phase 7's cluster and
# streamed mid-size city, each pair on the same seeds, cut from 16 spp to
# make room for phase 20): their launches, rates and finiteness
RATE_SPP = 4
# phase 17: the motion scenes (full width, 16 spp; the goldens' first 16
# samples at their size and seeds, whose random streams the card follows:
# PSNR >= MOTION_SEED_PSNR, phases 11-16's bar, and MOTION_SEED_PIXELS of
# the pixels within 1e-3: a knife-edge path or two of the motion box's
# 196,608 samples part from the golden's, whose XLA build fuses multiplies
# and adds, and one such pixel caps the PSNR near 80 dB;
# tests/test_torch_motion.py holds the passes lane by lane at 32 x 24),
# Whitted and
# the G-buffer against their deterministic goldens (tests/jax_zoo.py
# RT_BOX, RT_CITY): colours within RT_COLOR_TOL on RT_PIXELS_MIN of the
# pixels (the bench city's Woop test and the JAX brute trace's
# Moller-Trumbore test round its barycentrics apart, which moves its
# texture taps by a few 1e-4), the G-buffer's ids and fields on RT_IDS_MIN
# (a pick may differ where two samples' dissimilarities tie to rounding)
MOTION_BOX = dict(width=1024, height=768, depth=6)
MOTION_CITY = dict(n_blocks=32, subdiv=3, ground_subdiv=32, width=1024,
                   height=1024, depth=5)
MOTION_SPP = 16
# phases 6 and 20: the instanced city
ICITY = dict(n_blocks=32, subdiv=3, ground_subdiv=32, width=1024,
             height=1024, depth=5)
MOTION_SEED_PSNR = CITY_ZOO_SMALL_PSNR
MOTION_SEED_PIXELS = 0.999
# phase 21: a moving soup against its two-level twin at the same seeds, at
# RATE_SPP (a lerped matrix applied to a vertex is the lerp of the
# transformed ends, so the two images differ only where rounding parts a
# path), phase 6's bars for two routes of one scene
SOUP_TWIN_PSNR = 35.0
SOUP_TWIN_MEAN = 0.02
RT_COLOR_TOL = 1e-3
RT_PIXELS_MIN = 0.995
RT_IDS_MIN = 0.99
# phase 18: QMC and MLT at 16 spp (the goldens' samples, tests/jax_zoo.py
# QMC_SPP); the full-frame MLT with MLT_CHAINS chains takes
# 1024 * 768 * 16 / MLT_CHAINS = 24 steps of one batched pass each; at the
# golden's size it runs the golden's MLT_GOLD_CHAINS (48 steps), the
# merged image the CLI's 8,192.  The chains follow the golden's streams
# until an accept turns on a last-ulp difference.  The bar, set from the
# CPU port's run (scripts/qmc_mlt_cpu_bars.py): its MLT reads 141.71 dB
# against the golden and its merged image 139.54 dB, every pixel within
# 1e-3 (no chain parts), and a run at another seed, which follows none of
# the golden's chains, 18.75 dB: MLT_SEED_PSNR, phases 11-16's 60 dB, and
# MOTION_SEED_PIXELS of the pixels within 1e-3 hold the streams
QMC_SPP = 16
MLT_CHAINS = 1 << 19
MLT_GOLD_CHAINS = 4096
MLT_SEED_PSNR = CITY_ZOO_SMALL_PSNR
CLI_SPP = 4
# phase 19: differentiable rendering at drmain's width (diff_render/
# drmain.cpp:174-262: 512 x 512, depth 6, a 256 x 256 x 4 slot from 1.0,
# adam2 at lr 0.15, 1 spp an iteration; DR_ITERS iterations, not 50), its
# directional derivatives against central differences within JAX's 5%
# (tests/test_dr.py), the goldens (tests/jax_zoo.py dr_box) at their size
# and seeds; the camera plugin's renders (16 spp) and its golden
# (plugin_box, >= 60 dB as phases 11-18's seeds bars)
DR_SIZE = 512
DR_DEPTH = 6
DR_ITERS = 8
DR_LR = 0.15
DR_TARGET_SPP = 16
DR_FD_EPS = 1e-3
DR_FD_REL = 0.05
DR_OPT_DROP = 0.97     # JAX's bar: the last loss below 0.97 x the first
DR_GOLD_LOSS_RTOL = 1e-4
DR_GOLD_GRAD_RL2 = 1e-2
ZOO19 = dict(width=512, height=384, depth=6)   # the glass IOR's box
PLUGIN_SPP = 16
# the JAX camera-plugin test's biconvex lens (film-to-scene order)
PLUGIN_LENS = ((-0.05, 0.05, 1.0, 0.01), (0.05, 0.005, 1.5, 0.01))
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
# K4's motion variant at an instance: 13 cofactors (14 each), the
# determinant (7), 1 / det (2), 12 scalings, the ray into object space (33)
# and its inverse direction (6); the lerp of a moving instance's matrix
# (48) is not counted, so the bound stays a floor
MOTION_XFORM_OPS = 242
# K5m's triangle test: the row's lerp at the ray's time (9 multiplies, 9
# adds) before K5's Moller-Trumbore test
LERP_OPS = 18
CELL_OPS = 20      # cell exit planes and the step
# f32 operations of one K1 shade by the hit's material kind (the counting
# build counts shades per kind), reckoned from csrc/megakernel.cu (each add,
# multiply, divide, compare, min/max, sqrt, rsqrt, sin, cos and atan2 one).
# Every kind but a light source pays the hit's shade-row lerp, normal and
# flags (~75), the slot-0 texture tap (~85), NEE's light sample, shadow-ray
# set-up and MIS weight (~200, NEE_OPS with the material eval's share
# apart) and the bounce's throughput and next ray (~60); then:
#   gltf        GLTF eval (~250) and sample with its GGX sample (~430)
#   diffuse     Lambert/Oren-Nayar eval (~110) and cosine sample (~160)
#   conductor   TR eval with the complex Fresnel (~300) and VNDF sample
#               (~420)
#   dielectric  no eval; FrDielectricDetailedV2 and the refraction (~130)
#   glass       no eval; fresnel2, reflect2 and refract2 (~110)
#   light       the RNG draws NEE skips to, and the light-hit branch (~180
#               in all)
SHADE_OPS = {'gltf': 1100, 'diffuse': 690, 'conductor': 1140,
             'dielectric': 550, 'glass': 530, 'light': 180}
SHADE_KINDS = ('gltf', 'diffuse', 'conductor', 'dielectric', 'glass',
               'light')
# what a shade of K1's spectral variant adds, by kind: the light's SPD at 4
# wavelengths in NEE or at a light hit (4 lerps, ~40); a diffuse's SPD in
# its eval and sample (~80); a conductor's eta and k SPDs in its eval and
# sample (~160) and three more complex Fresnels in each (~300).  A sample
# adds its wavelength draw and the CIE conversion (SPEC_SAMPLE_OPS)
SPEC_SHADE_EXTRA = {'gltf': 40, 'diffuse': 120, 'conductor': 500,
                    'dielectric': 40, 'glass': 40, 'light': 40}
SPEC_SAMPLE_OPS = 70
# NEE's share of a non-light shade (light sample, shadow-ray set-up, MIS
# weight, the shade): the naive integrator runs none of it
NEE_OPS = 200
# lanes of the tessellated box held against the plain version (its brute
# trace over 4,096 rows is slow at full width); timing stays at full width
TESS_LANES = 65536


def log(msg):
    print(msg, flush=True)


def shade_ops(counts, naive=False, spectral=False):
    """f32 operations of the shades the counting build counted (its counts
    [2:8], by material kind); ``spectral``: with the spectral variant's
    SPD fetches."""
    shades = counts[2:2 + len(SHADE_KINDS)]
    ops = sum(c * (SHADE_OPS[k] + (SPEC_SHADE_EXTRA[k] if spectral else 0))
              for c, k in zip(shades, SHADE_KINDS))
    if naive:
        ops -= NEE_OPS * sum(shades[:-1])
    return ops


def layout_line(attrs):
    """K1's launch at one pack (``megakernel.kernel_attrs(lib, pk)``): per
    entry point its pool (or one lane a thread), its layout (geometry and
    walk stacks on chip or in device memory), shared bytes a block, blocks
    an SM, registers and local bytes."""
    def one(k, a):
        pool = (f'pool {a["pool"]} lanes' if a['pool']
                else 'one lane a thread')
        return (f'{k} {pool}, layout {a["layout"]}, {a["shared_bytes"]} '
                f'shared B a block, {a["blocks_per_sm"]} blocks an SM, '
                f'{a["registers"]} registers, {a["local_bytes"]} local B')
    return '; '.join(one(k, a) for k, a in attrs.items())


def streamed_launched(n, integrator):
    """A streamed render launched K3 for its nearest hits and, unless it is
    naive (no shadow rays; K2 then runs only for lanes the march leaves),
    K2 for its shadow rays."""
    return n['intersect_march'] > 0 and (integrator == 0
                                         or n['intersect_stream'] > 0)


def check(ok, msg):
    """A check that fails the run once every phase has run."""
    if not ok:
        log(f'  FAILED: {msg}')
        DEFERRED.append(msg)


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


def ray_query_bound(counts, n_rays, out_words, tables, tri_ops=WOOP_OPS,
                    inst_ops=XFORM_OPS):
    """Bound of one ray query: rays (32 bytes) and outputs once, each table
    once; the operations its counted launch reported."""
    slab, tri, inst, cell = counts
    ops = (slab * SLAB_OPS + tri * tri_ops + inst * inst_ops
           + cell * CELL_OPS)
    moved = round(n_rays * (32 + 4 * out_words)) + nbytes(*tables)
    ms, by = bound(moved, ops)
    return ms, by, dict(box_tests=slab, tri_tests=tri, instances=inst,
                        cells=cell, bytes=moved, operations=ops)


# checks that fail the run only once every phase has run, so that one run
# shows every such lane (the equal-t ties)
DEFERRED = []


def compare(name, kernel, plain, any_hit=False, query=None, explain=None,
            exact=False):
    """Kernel vs plain on every lane (``traverse_stream.hits_agree``): the
    hit flags and, where both hit, t to rtol 2e-4 must agree on AGREE_MIN
    of the lanes, the triangle on AGREE_MIN of the both-hit lanes, and the
    barycentrics u and v to UV_TOL on every lane where both report the
    same triangle.  ``exact`` (K5, whose test rounds as the plain
    version's): no lane with another hit flag and, for a nearest hit, no
    lane with another triangle, t, u or v.  With the ``query`` (pos, dir,
    t_min, t_max) given (the kernels whose Woop test rounds as the plain
    version's: K2, K3) no
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
    if exact and (a['hit_diff'] or (not any_hit and (
            a['tri_diff'] or a['max_dt'] or a['max_duv']))):
        raise RuntimeError(f'{name}: {a["hit_diff"]} lanes with another hit '
                           f'flag, {a["tri_diff"]} with another triangle, '
                           f'max|dt| {a["max_dt"]:.3e}, max|du|,|dv| '
                           f'{a["max_duv"]:.3e} (every lane must equal the '
                           'plain version)')
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


def phase19(dev, city, gold_box, gold_city, counters, zero_counts,
            golden_size):
    """Differentiable rendering on the DR box (K5) and the camera plugin on
    the box (K5) and the bench city (``city``, K3/K2).  Returns its
    record and the DR box (scene, meta)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from hydracore3_torch import camera_plugin as CP
    from hydracore3_torch import render as R
    from hydracore3_torch.accel import hit_grad as HG
    from hydracore3_torch.accel import traverse_pallas as TPL
    from hydracore3_torch.models import dr as DR
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    import zoo_scenes as Z
    t19 = time.perf_counter()

    def at(msg):
        log(f'  {msg} ({time.perf_counter() - t19:.1f} s into phase 19)')

    def launched():
        return {w_.__name__: w_.launches for w_ in counters if w_.launches}

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            OpCount.n += 1
            return func(*args, **(kwargs or {}))

    def lane_loss(contrib, ref):
        d = contrib[:, :3].double() - ref.double()
        return (d * d).sum(-1)

    def one_sample(sc, mt, rng, pix):
        return R._one_sample(sc, mt, rng, pix, IPT.INTEGRATOR_MIS_PT)[0]

    def rel_l2(a, b):
        a, b = a.double(), b.double()
        return float((a - b).norm() / b.norm().clamp(min=1e-30))

    k5 = {'intersect_clusters'}
    rec = {}
    tmp = tempfile.TemporaryDirectory()
    dpath = Z.write_dr_box(os.path.join(tmp.name, 'dr'), DR_SIZE, DR_SIZE,
                           DR_DEPTH)
    dsc, dmt = B.load_scene(dpath, device=dev)
    setup = DR.put_diff_tex(dsc, Z.dr_tex_slot(dsc))
    n = dmt.width * dmt.height
    pix = torch.arange(n, device=dev)
    log(f'[19] differentiable rendering: the DR box {dmt.width}x'
        f'{dmt.height}, depth {dmt.trace_depth}, {dmt.num_tris} triangles, '
        f'the trainable slot {setup.slot} ({setup.width}x{setup.height}x4); '
        f'K1 gate: {R.use_megakernel(dsc, dmt)} (DR takes the batched '
        f'integrator: render._one_sample)')
    zero_counts()
    target = R.render(dsc, dmt, spp=DR_TARGET_SPP)
    log(f'  the target: render.render of the true scene, {DR_TARGET_SPP} '
        f'spp, launches {launched()}, mean {float(target[..., :3].mean()):.6f}')
    ref = torch.from_numpy(np.ascontiguousarray(
        target[..., :3].reshape(n, 3))).to(dev)

    # K5 on the DR box's queries, and the hit's backward on the card
    st = IPT.kernel_init_eye_ray(dsc, dmt, RNG.gen_init(pix), pix)
    queries = [('camera', st.ray_pos, st.ray_dir)]
    st = IPT.kernel_ray_trace(dsc, dmt, st, 0)
    st = IPT.kernel_next_bounce(dsc, dmt, st, 0, torch.zeros_like(
        st.accum_color), IPT.MAT.make_shading_ctx(
            dsc, dmt, IPT._extract_mat_id(st.flags), st.hit_norm,
            st.hit_tang, st.hit_uv))
    queries.append(('first bounce', st.ray_pos, st.ray_dir))
    rec['hit'] = {}
    tris = dsc.cl_tris12
    for label, pos, d in queries:
        t_min = torch.zeros(n, device=dev)
        t_max = torch.full((n,), 3.4e38, device=dev)
        cot = torch.from_numpy(np.random.default_rng(len(rec['hit'])).normal(
            size=(3, n)).astype(np.float32)).to(dev)

        def grads(fn):
            p, q = pos.clone().requires_grad_(), d.clone().requires_grad_()
            t, tri, u, v = fn(p, q)
            out = sum((torch.where(tri >= 0, x, 0.0) * c).sum()
                      for x, c in zip((t, u, v), cot))
            return (t.detach(), tri, u.detach(), v.detach(),
                    *torch.autograd.grad(out, (p, q)))

        ka = grads(lambda p, q: HG.nearest_with_grad(
            lambda a, b: TPL.intersect_clusters(
                None, None, tris, a, b, t_min, t_max, wide=dsc.cl_wide),
            HG.cluster_rows(tris), p, q))
        pa = grads(lambda p, q: TPL.intersect_clusters_plain(
            tris, p, q, t_min, t_max))
        same = bool(torch.equal(ka[1], pa[1]) and all(
            torch.equal(x, y) for x, y in zip(ka[:4], pa[:4])))
        fin = torch.isfinite(pa[4]).all(-1) & torch.isfinite(pa[5]).all(-1)
        close = (torch.isclose(ka[4], pa[4], rtol=1e-4, atol=1e-4).all(-1)
                 & torch.isclose(ka[5], pa[5], rtol=1e-4, atol=1e-4).all(-1))
        share = float(close[fin].float().mean())
        kfin = bool(torch.isfinite(ka[4]).all() and torch.isfinite(
            ka[5]).all())
        log(f'  K5 on the DR box\'s {label} query ({n} lanes): t, tri, u, v '
            f'equal to the plain version on every lane {same}; the hit\'s '
            f'backward (accel/hit_grad.py) finite {kfin}, within 1e-4 of the '
            f'plain version\'s autograd gradient on {share:.6f} of the '
            f'{int(fin.sum())} lanes where that is finite')
        check(same and kfin and share >= AGREE_MIN and float(
            fin.float().mean()) >= 0.99, f'K5 / the hit\'s backward on the '
            f'DR box\'s {label} query: equal {same}, backward {share:.6f}')
        rec['hit'][label] = dict(equal=same, backward_close=share)
    del queries, st
    at('K5 and the hit\'s backward checked')

    # (a) the full-width loss_and_grad at drmain's start, 1.0
    params0 = torch.full((setup.size, 4), 1.0, device=dev)
    zero_counts()
    loss, g, contrib, _ = DR.loss_and_grad(params0, dsc, dmt, setup,
                                           RNG.gen_init(pix), pix, ref)
    n_l = launched()
    nz = int((g.abs().sum(-1) > 0).sum())
    ok = (bool(torch.isfinite(g).all()) and np.isfinite(float(loss))
          and nz > 0 and set(n_l) == k5)
    log(f'  (a) loss_and_grad {n} lanes: loss {float(loss):.6f}, gradient '
        f'finite {bool(torch.isfinite(g).all())}, {nz} of {setup.size} '
        f'texels with a non-zero gradient, launches {n_l}')
    check(ok, f'(a) loss_and_grad: loss {float(loss)}, {nz} texels, '
          f'launches {n_l}')
    rec['a'] = dict(loss=float(loss), texels_nonzero=nz, launches=n_l)

    # (b) the directional derivative along a seeded direction
    params = torch.from_numpy(Z.dr_gold_params(setup.size)).to(dev)
    _, g, _, _ = DR.loss_and_grad(params, dsc, dmt, setup, RNG.gen_init(pix),
                                  pix, ref)
    direction = torch.from_numpy(np.random.default_rng(0).normal(
        size=(setup.size, 4)).astype(np.float32)).to(dev)
    rng0 = RNG.gen_init(pix)

    def tex_loss(e):
        return float(lane_loss(one_sample(DR.scene_with_params(
            dsc, setup, params + e * direction), dmt, rng0, pix), ref).sum())

    fd = (tex_loss(DR_FD_EPS) - tex_loss(-DR_FD_EPS)) / (2 * DR_FD_EPS)
    ad = float((g.double() * direction.double()).sum())
    off = abs(fd - ad) / max(abs(fd), abs(ad), 1e-3)
    log(f'  (b) the texels\' directional derivative: autograd {ad:.6f}, '
        f'central differences (eps {DR_FD_EPS}, f64 sums) {fd:.6f}: '
        f'{100 * off:.3f}% apart')
    check(off <= DR_FD_REL, f'(b) texel derivative {ad} vs {fd}')
    rec['b'] = dict(autograd=ad, central=fd, off=off)
    at('(a), (b) checked')

    # (c) material columns: the back wall's red; the zoo box's glass IOR
    ids = Z.material_ids(dpath)
    zpath = Z.write_zoo_box(os.path.join(tmp.name, 'zoo'), **ZOO19)
    zsc, zmt = B.load_scene(zpath, device=dev)
    zids = Z.material_ids(zpath)
    rec['c'] = {}
    for label, sc, mt, mid, col, zref in (
            ('colour', dsc, dmt, ids['dr_back'], 0, ref),
            ('glass_ior', zsc, zmt, zids['zoo_glass'], Z.IOR_COLUMN, None)):
        nn = mt.width * mt.height
        px = torch.arange(nn, device=dev)
        rg = RNG.gen_init(px)
        if zref is None:
            zref = torch.from_numpy(Z.ior_gold_ref(nn)).to(dev)
        msetup = DR.DiffMatSetup((mid,), (col,))
        flat = torch.cat([sc.mat_colors.reshape(-1, 16), sc.mat_row0.reshape(
            -1, 16), sc.mat_row1.reshape(-1, 16), sc.mat_data], -1)
        p0 = flat[mid:mid + 1, col:col + 1].clone()
        zero_counts()
        _, mg, _ = DR.mat_loss_and_grad(p0, sc, mt, msetup, rg, px, zref)
        n_m = launched()

        def mat_loss(e):
            return lane_loss(one_sample(DR.scene_with_mat_params(
                sc, msetup, p0 + e), mt, rg, px), zref)

        d1, smooth = Z.smooth_lanes(mat_loss, DR_FD_EPS)
        if label == 'colour':
            sel = px
        else:
            sel = torch.nonzero(smooth).squeeze(1)
        _, mg_s, _ = DR.mat_loss_and_grad(p0, sc, mt, msetup, rg[sel],
                                          px[sel], zref[sel])
        fd, ad = float(d1[sel].sum()), float(mg_s)
        off = abs(fd - ad) / max(abs(fd), abs(ad), 1e-3)
        share = float(smooth.float().mean())
        log(f'  (c) mat_loss_and_grad {label} (material {mid}, packed column '
            f'{col} = {float(p0):.4f}) {mt.width}x{mt.height}: the whole '
            f'loss\'s derivative {float(mg):.6f} (central differences '
            f'{float(d1.sum()):.6f}), launches {n_m}; {share:.6f} of the '
            f'lanes smooth on the step; over '
            f'{"every lane" if label == "colour" else "the smooth lanes"}: '
            f'autograd {ad:.6f}, central differences {fd:.6f}, '
            f'{100 * off:.3f}% apart')
        check(bool(torch.isfinite(mg).all()) and off <= DR_FD_REL
              and set(n_m) == k5, f'(c) {label}: {ad} vs {fd}, launches '
              f'{n_m}')
        rec['c'][label] = dict(whole_autograd=float(mg),
                               whole_central=float(d1.sum()),
                               smooth_share=share, autograd=ad, central=fd,
                               off=off, launches=n_m)
    at('(c) checked')

    # (d) Whitted
    zero_counts()
    wl, wg = DR.whitted_loss_and_grad(params, dsc, dmt, setup, pix, ref)
    n_w = launched()
    wnz = int((wg.abs().sum(-1) > 0).sum())
    log(f'  (d) whitted_loss_and_grad: loss {float(wl):.6f}, gradient finite '
        f'{bool(torch.isfinite(wg).all())}, {wnz} texels non-zero, launches '
        f'{n_w}')
    check(np.isfinite(float(wl)) and bool(torch.isfinite(wg).all())
          and wnz > 0 and set(n_w) == k5, f'(d) whitted: {float(wl)}, {wnz}')
    rec['d'] = dict(loss=float(wl), texels_nonzero=wnz, launches=n_w)

    # (e) drmain's loop, DR_ITERS iterations
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    _, losses = DR.optimize_texture(dsc, dmt, setup, target, iters=DR_ITERS,
                                    spp=1, lr=DR_LR, verbose=False)
    opt_s = time.perf_counter() - t0
    n_o = launched()
    peak = torch.cuda.max_memory_allocated(dev)
    mono = all(b <= a for a, b in zip(losses, losses[1:]))
    drop = losses[-1] / losses[0]
    # JAX's bars for drmain's configuration (tests/test_dr.py
    # test_drmain_configuration_50_iters): the loss falls, and its least
    # value is among the last iterations (no late divergence; the last
    # half of DR_ITERS here, the last 10 of 50 there).  Adam at lr 0.15 may
    # step past the minimum once the loss has fallen far
    late = min(losses) == min(losses[len(losses) // 2:])
    # one iteration's forward and backward apart, and their eager ops
    p1 = params0.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.enable_grad():
        lo, _ = DR.pixel_loss(p1, dsc, dmt, setup, RNG.gen_init(pix), pix,
                              ref)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(lo, p1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    OpCount.n = 0
    with OpCount(), torch.enable_grad():
        lo, _ = DR.pixel_loss(p1, dsc, dmt, setup, RNG.gen_init(pix), pix,
                              ref)
        fwd_ops = OpCount.n
        torch.autograd.grad(lo, p1)
    bwd_ops = OpCount.n - fwd_ops
    log(f'  (e) optimize_texture {DR_ITERS} iterations, 1 spp, adam2 lr '
        f'{DR_LR}: {opt_s:.2f} s ({opt_s / DR_ITERS:.3f} s an iteration), '
        f'losses {[round(x, 6) for x in losses]}, non-increasing {mono}, '
        f'least among the last half {late}, last / first {drop:.4f}, '
        f'launches {n_o}, peak device memory '
        f'{peak / 2**30:.3f} GiB; one iteration: forward {t1 - t0:.3f} s '
        f'({fwd_ops} eager ops), backward {t2 - t1:.3f} s ({bwd_ops} eager '
        f'ops)')
    check(late and drop < DR_OPT_DROP and set(n_o) == k5
          and np.isfinite(losses).all(), f'(e) losses {losses}')
    rec['e'] = dict(losses=losses, non_increasing=mono, seconds=opt_s,
                    launches=n_o,
                    peak_bytes=peak, forward_s=t1 - t0, backward_s=t2 - t1,
                    forward_ops=fwd_ops, backward_ops=bwd_ops)
    del p1, lo
    at('(d), (e) checked')

    # (f) the goldens at their size and seeds
    gd = np.load(Z.golden_path('dr_box_128.npz'))
    gsc, gmt = golden_size(dsc, dmt, gd['target'].shape[1],
                           gd['target'].shape[0])
    gn = gmt.width * gmt.height
    gpix = torch.arange(gn, device=dev)
    gref = torch.from_numpy(np.ascontiguousarray(
        gd['target'][..., :3].reshape(gn, 3))).to(dev)
    gl, gg, _, _ = DR.loss_and_grad(params, gsc, gmt, setup,
                                    RNG.gen_init(gpix), gpix, gref)
    loss_off = abs(float(gl) / float(gd['loss']) - 1.0)
    grad_off = rel_l2(gg, torch.from_numpy(gd['grad']).to(dev))
    _, glosses = DR.optimize_texture(gsc, gmt, setup, gd['target'],
                                     iters=len(gd['losses']), spp=1,
                                     lr=DR_LR, verbose=False)
    losses_off = float(np.max(np.abs(np.asarray(glosses) / gd['losses']
                                     - 1.0)))
    gi = np.load(Z.golden_path('dr_box_ior_128.npz'))
    isc, imt = golden_size(zsc, zmt, Z.IOR_GOLD['width'],
                           Z.IOR_GOLD['height'])
    inn = imt.width * imt.height
    ipix = torch.arange(inn, device=dev)
    il, ig, _ = DR.mat_loss_and_grad(
        torch.from_numpy(gi['ior']).to(dev), isc, imt,
        DR.DiffMatSetup((zids['zoo_glass'],), (Z.IOR_COLUMN,)),
        RNG.gen_init(ipix), ipix, torch.from_numpy(Z.ior_gold_ref(inn)).to(
            dev))
    ior_off = abs(float(il) / float(gi['loss']) - 1.0)
    log(f'  (f) at the DR golden\'s size and seeds ({gmt.width}x{gmt.height}):'
        f' loss {100 * loss_off:.5f}% off, texel gradient relative L2 '
        f'{grad_off:.3e}; {len(glosses)} optimize_texture losses at most '
        f'{100 * losses_off:.5f}% off; the zoo box\'s glass IOR at '
        f'{imt.width}x{imt.height}: loss {100 * ior_off:.5f}% off, gradient '
        f'{float(ig):.6f} (JAX\'s: {float(gi["grad"].reshape(-1)[0])})')
    check(loss_off <= DR_GOLD_LOSS_RTOL and grad_off <= DR_GOLD_GRAD_RL2
          and losses_off <= DR_GOLD_LOSS_RTOL and ior_off <= DR_GOLD_LOSS_RTOL
          and bool(torch.isfinite(ig).all()),
          f'(f) goldens: loss {loss_off}, gradient {grad_off}, losses '
          f'{losses_off}, IOR loss {ior_off}')
    rec['f'] = dict(loss_off=loss_off, grad_rel_l2=grad_off,
                    losses_off=losses_off, ior_loss_off=ior_off,
                    ior_grad=float(ig))
    del gsc, isc, zsc, gg, g, contrib
    at('(f) checked')

    # the camera plugin
    box = synth.box_scene(1024, 768, depth=6, textured=True, device=dev)
    rec['plugin'] = {}
    routes = {'box': k5, 'bench city': {'intersect_march',
                                        'intersect_stream'}}
    for label, (sc, mt), gold in (('box', box, gold_box),
                                  ('bench city', city, gold_city)):
        cam = CP.CamPinHole.match_scene_camera(
            CP.CamParameters(width=mt.width, height=mt.height), sc)
        zero_counts()
        t0 = time.perf_counter()
        img = CP.render_with_camera_plugin(sc, mt, cam, spp=PLUGIN_SPP)
        secs = time.perf_counter() - t0
        n_p = launched()
        p_, m_ = psnr_mean(img, gold)
        tiles = -(-mt.width * mt.height // CP.MEGA_TILE)
        log(f'  camera plugin, {label} {mt.width}x{mt.height} ({tiles} tiles '
            f'of {CP.MEGA_TILE} rays, each from gen_init of its ray ids) '
            f'{PLUGIN_SPP} spp: {secs:.2f} s, '
            f'{mt.width * mt.height * PLUGIN_SPP / secs / 1e6:.4f} '
            f'Msamples/s, launches {n_p}; vs golden PSNR {p_:.2f} dB, mean '
            f'{100 * m_:.3f}% off')
        check(np.isfinite(img).all() and set(n_p) == routes[label]
              and p_ >= PSNR_MIN and m_ <= MEAN_TOL,
              f'camera plugin {label}: {p_:.2f} dB, mean {100 * m_:.3f}% '
              f'off, launches {n_p}')
        rec['plugin'][label] = dict(seconds=secs, launches=n_p, golden_db=p_,
                                    golden_mean_off=m_)
        del img
    gp = np.load(Z.golden_path('plugin_box_128.npz'))['img']
    psc, pmt = golden_size(*box, gp.shape[1], gp.shape[0])
    cam = CP.CamPinHole.match_scene_camera(
        CP.CamParameters(width=pmt.width, height=pmt.height), psc)
    zero_counts()
    img = CP.render_with_camera_plugin(psc, pmt, cam, spp=PLUGIN_SPP)
    pg, mg_ = psnr_mean(img, gp)
    near = float((np.abs(img[..., :3] - gp).max(-1) <= 1e-3).mean())
    log(f'  camera plugin at its golden\'s size and seeds ({pmt.width}x'
        f'{pmt.height}, {PLUGIN_SPP} spp): PSNR {pg:.2f} dB, mean '
        f'{100 * mg_:.5f}% off, {near:.6f} of the pixels within 1e-3, '
        f'launches {launched()}')
    check(pg >= CITY_ZOO_SMALL_PSNR, f'plugin golden: {pg:.2f} dB')
    rec['plugin']['seeds_db'] = pg
    lcam = CP.CamTableLens.match_scene_camera(
        CP.CamParameters(width=512, height=384), box[0],
        lens_lines=PLUGIN_LENS, phys_size=(0.035, 0.035))
    lp = torch.arange(512 * 384, device=dev)
    _, _, _, _, _, aux = lcam.make_rays_block(lcam.init_rng(lp.shape[0]), lp)
    valid = float((aux > 0).float().mean())
    limg = CP.render_with_camera_plugin(box[0], box[1], lcam, spp=1)
    log(f'  the table-lens camera (the biconvex lens of JAX\'s test) '
        f'512x384: {valid:.4f} of the rays through the stack, image finite '
        f'{bool(np.isfinite(limg).all())}, mean {float(limg[..., :3].mean()):.6f}')
    check(0.0 < valid and np.isfinite(limg).all(),
          f'table lens: valid share {valid}')
    rec['plugin']['lens_valid_share'] = valid
    tmp.cleanup()
    log(f'  phase 19: {time.perf_counter() - t19:.1f} s')
    return rec, (dsc, dmt)


def phase20(dev, city, city_img, city4, dr_box, counters, zero_counts,
            first_bounce_queries):
    """Data parallelism (``parallel/mesh.py``) over NCCL at world size 1,
    ``count_rays_pass`` and the hit's gradient on the two-level classes
    (K4, K4m).  ``city`` is the bench city, ``city_img`` phase 4's image,
    ``city4`` phase 4's seconds and launches and ``dr_box`` phase 19's DR
    box.  Returns its record."""
    import socket
    import torch.distributed as dist
    from hydracore3_torch.accel import hit_grad as HG
    from hydracore3_torch.accel import traverse_tlas as TT
    from hydracore3_torch.accel import two_level as TL2
    from hydracore3_torch.accel import wide_bvh as WB
    from hydracore3_torch.models import dr as DR
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.parallel import mesh as M
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth
    import zoo_scenes as Z
    t20 = time.perf_counter()

    def at(msg):
        log(f'  {msg} ({time.perf_counter() - t20:.1f} s into phase 20)')

    def launched():
        return {w_.__name__: w_.launches for w_ in counters if w_.launches}

    rec = {}
    scene, meta = city
    n = meta.width * meta.height
    pix = torch.arange(n, device=dev)
    streamed = {'intersect_march', 'intersect_stream'}

    # (a) the process group: torchrun's variables, world size 1, NCCL
    with socket.socket() as s_:
        s_.bind(('127.0.0.1', 0))
        port = s_.getsockname()[1]
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      WORLD_SIZE='1', RANK='0')
    t0 = time.perf_counter()
    mesh = M.init_distributed()
    x = torch.full((4,), 3.0, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ok = (mesh.backend == 'nccl' and mesh.world_size == 1
          and mesh.device == dev and bool((x == 3.0).all()))
    log(f'[20] data parallelism: init_distributed() from MASTER_ADDR, '
        f'MASTER_PORT {port}, WORLD_SIZE 1, RANK 0: backend '
        f'{mesh.backend}, rank {mesh.rank} of {mesh.world_size} on '
        f'{mesh.device}, one all_reduce right {bool((x == 3.0).all())}; '
        f'{init_s:.2f} s')
    check(ok, f'(a) process group: backend {mesh.backend}, world '
          f'{mesh.world_size}')
    rec['a'] = dict(backend=mesh.backend, seconds=init_s)

    # (b) the bench city sharded, against phase 4's render
    zero_counts()
    t0 = time.perf_counter()
    img = M.render_sharded(mesh, scene, meta, spp=16, tile_size=1 << 20)
    secs = time.perf_counter() - t0
    n_b = launched()
    same = bool(np.array_equal(img, city_img))
    want = {k: city4['launches'][k] for k in streamed}
    log(f'  (b) render_sharded, the bench city {meta.width}x{meta.height} '
        f'16 spp over 1 rank: {secs:.2f} s, {n * 16 / secs / 1e6:.4f} '
        f'Msamples/s (phase 4: {city4["seconds"]:.2f} s, '
        f'{n * 16 / city4["seconds"] / 1e6:.4f}); launches {n_b} (phase '
        f'4: {want}); equal to phase 4\'s image bit for bit {same}')
    check(same and n_b == want and all(want.values()),
          f'(b) sharded city: equal {same}, '
          f'launches {n_b} vs {want}')
    rec['b'] = dict(seconds=secs, phase4_seconds=city4['seconds'],
                    launches=n_b, equal=same)
    del img
    at('(b) checked')

    # (c) one sharded DR step on phase 19's DR box against loss_and_grad,
    # both with torch's deterministic algorithms (the texel gradient's
    # accumulation otherwise varies in its last bits between runs)
    dsc, dmt = dr_box
    setup = DR.put_diff_tex(dsc, Z.dr_tex_slot(dsc))
    dn = dmt.width * dmt.height
    dpix = torch.arange(dn, device=dev)
    params = torch.from_numpy(Z.dr_gold_params(setup.size)).to(dev)
    ref = torch.from_numpy(Z.ior_gold_ref(dn)).to(dev)

    def loss_fn(p, sc, rng_, px, ref_):
        return DR.pixel_loss(p, sc, dmt, setup, rng_, px, ref_)[0]

    step = M.sharded_train_step(mesh, dsc, dmt, loss_fn)
    det = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        zero_counts()
        t0 = time.perf_counter()
        loss, g = step(params, RNG.gen_init(dpix), dpix, ref)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        n_c = launched()
        t0 = time.perf_counter()
        loss2, g2, _, _ = DR.loss_and_grad(params, dsc, dmt, setup,
                                           RNG.gen_init(dpix), dpix, ref)
        torch.cuda.synchronize()
        lg_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(det)
    same = bool(torch.equal(loss, loss2) and torch.equal(g, g2))
    diff = int((g != g2).sum())
    log(f'  (c) sharded_train_step, the DR box {dmt.width}x{dmt.height} '
        f'depth {dmt.trace_depth} over 1 rank: loss {float(loss):.6f}, '
        f'{int((g.abs().sum(-1) > 0).sum())} of {setup.size} texels with a '
        f'non-zero gradient, {step_s:.2f} s (loss_and_grad {lg_s:.2f} s), '
        f'launches {n_c}; loss and '
        f'gradient equal to dr.loss_and_grad\'s bit for bit {same} '
        f'({diff} gradient entries differ)')
    check(same and n_c == {'intersect_clusters': 2 * dmt.trace_depth},
          f'(c) sharded DR step: equal {same}, launches {n_c}')
    rec['c'] = dict(loss=float(loss), seconds=step_s,
                    loss_and_grad_seconds=lg_s, launches=n_c,
                    equal=same)
    del dsc, dr_box, g, g2
    at('(c) checked')

    # (d) count_rays_pass on the bench city, one pass
    zero_counts()
    t0 = time.perf_counter()
    n_near, n_shadow = IPT.count_rays_pass(scene, meta, RNG.gen_init(pix),
                                           pix)
    count_s = time.perf_counter() - t0
    n_d = launched()
    mrays = (n_near + n_shadow) * 16 / city4['seconds'] / 1e6
    log(f'  (d) count_rays_pass, the bench city, one pass: {n_near} '
        f'nearest-hit rays, {n_shadow} shadow rays ({count_s:.2f} s, '
        f'launches {n_d}); over phase 4\'s 16 spp in '
        f'{city4["seconds"]:.2f} s: {mrays:.3f} Mrays/s')
    check(set(n_d) == streamed and 0 < n_shadow < n_near <= n * 5,
          f'(d) count_rays_pass: {n_near}, {n_shadow}, launches {n_d}')
    rec['d'] = dict(n_nearest=n_near, n_shadow=n_shadow, seconds=count_s,
                    mrays_s=mrays, launches=n_d)
    at('(d) checked')

    # (e) the hit's gradient on the two-level classes: K4 on the instanced
    # city's camera query (its plain walk on the first 65,536 lanes: the
    # walk's Woop test at its hit under autograd, since the dense walk's
    # gradient is NaN at its padding rows), K4m on the motion box's three
    # queries (the dense plain walk under autograd, every lane)
    rec['e'] = {}

    def backward_check(label, fn, plain, q, sub):
        """The Function's (t, tri, u, v, inst) and gradient of a seeded
        cotangent against ``plain``'s on the lanes ``sub``."""
        nq = q[0].shape[0]
        cot = torch.from_numpy(np.random.default_rng(len(rec['e'])).normal(
            size=(3, nq)).astype(np.float32)).to(dev)

        def grads(f, pos, d, c):
            p_, q_ = pos.clone().requires_grad_(), d.clone().requires_grad_()
            t, tri, u, v, inst = f(p_, q_)
            loss_ = sum((torch.where(tri >= 0, x_, 0.0) * c_).sum()
                        for x_, c_ in zip((t, u, v), c))
            return (tri, inst, *torch.autograd.grad(loss_, (p_, q_)))

        zero_counts()
        ka = grads(fn, q[0], q[1], cot)
        n_k = launched()
        pa = grads(plain, q[0][sub], q[1][sub], cot[:, sub])
        hits_eq = bool(torch.equal(ka[0][sub], pa[0])
                       and torch.equal(ka[1][sub], pa[1]))
        kfin = bool(torch.isfinite(ka[2]).all() and torch.isfinite(
            ka[3]).all())
        fin = torch.isfinite(pa[2]).all(-1) & torch.isfinite(pa[3]).all(-1)
        close = (torch.isclose(ka[2][sub], pa[2], rtol=1e-4,
                               atol=1e-4).all(-1)
                 & torch.isclose(ka[3][sub], pa[3], rtol=1e-4,
                                 atol=1e-4).all(-1))
        share = float(close[fin].float().mean())
        log(f'  (e) {label}: {int((ka[0] >= 0).sum())} of {nq} lanes hit, '
            f'launches {n_k}; against the plain walk on '
            f'{pa[0].shape[0]} lanes: hits equal {hits_eq}, the backward '
            f'finite {kfin}, within 1e-4 of the plain autograd gradient on '
            f'{share:.6f} of the {int(fin.sum())} lanes where that is finite')
        check(hits_eq and kfin and share >= AGREE_MIN
              and float(fin.float().mean()) >= 0.99,
              f'(e) {label}: hits {hits_eq}, finite {kfin}, close {share}')
        rec['e'][label] = dict(launches=n_k, close=share, hits_equal=hits_eq)
        return n_k

    icity, imeta = synth.instanced_city_scene(**ICITY, accel='stream_tlas',
                                              device=dev)
    pack = icity.tt
    cam, _, _, _ = first_bounce_queries(icity, imeta)
    t_min, t_max = cam[2], cam[3]
    sub = slice(0, 65536)

    def tlas_plain(p_, q_):
        with torch.no_grad():
            _, tri, _, _, inst = TT.intersect_tlas_plain(
                pack, p_, q_, t_min[sub], torch.clamp(t_max[sub],
                                                      max=TT.T_MAX_CAP))
        op, od = TT.to_object_space(pack.inst_f[inst.clamp(min=0)].T, p_, q_)
        t, u, v, _ = WB._woop(pack.woop[tri.clamp(min=0)], op, od)
        return t, tri, u, v, inst

    n_k4 = backward_check(
        'K4, the instanced city\'s camera query', lambda p_, q_:
        HG.tlas_with_grad(pack, p_, q_, t_min, t_max), tlas_plain, cam, sub)
    del icity, pack, cam
    tmp = tempfile.TemporaryDirectory()
    mb, mbm = B.load_scene(Z.write_motion_box(os.path.join(tmp.name, 'mb'),
                                              **MOTION_BOX), device=dev)
    tl = mb.two_level
    mpix = torch.arange(mbm.width * mbm.height, device=dev)
    mtime = IPT.kernel_init_eye_ray(mb, mbm, RNG.gen_init(mpix), mpix).time
    n_k4m = 0
    for qlabel, q in zip(('camera', 'shadow', 'bounce'),
                         first_bounce_queries(mb, mbm)[:3]):
        def k4m(p_, q_, q=q):
            t, tri, inst, u, v = HG.two_level_with_grad(tl, p_, q_, q[2],
                                                        q[3], mtime)
            return t, tri, u, v, inst

        def k4m_plain(p_, q_, q=q):
            t, tri, inst, u, v = TL2.intersect_two_level_plain(
                tl, p_, q_, q[2], q[3], mtime)
            return t, tri, u, v, inst

        n_k4m += backward_check(f'K4m, the motion box\'s {qlabel} rays',
                                k4m, k4m_plain, q, slice(None)).get(
            'intersect_two_level', 0)
    tmp.cleanup()
    at('(e) checked')
    dist.destroy_process_group()
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
        os.environ.pop(k, None)
    rec['launches'] = {k: n_b.get(k, 0) + n_d.get(k, 0) for k in streamed}
    rec['launches'].update(
        intersect_clusters=n_c.get('intersect_clusters', 0),
        intersect_stream_tlas=n_k4.get('intersect_stream_tlas', 0),
        intersect_two_level=n_k4m)
    rec['seconds'] = time.perf_counter() - t20
    log(f'  phase 20: {rec["seconds"]:.1f} s')
    return rec


def phase21(dev, paths, counters, zero_counts, first_bounce_queries,
            query_counts, golden_size, count_lib):
    """The flattened-soup route with per-triangle motion: the motion box
    and the motion city (phase 17's libraries, ``paths``) built under
    ``accel='bvh'``, traced at each ray's time through the cluster kernel's
    moving variant (K5m).  Returns its record."""
    from hydracore3_torch import render as R
    from hydracore3_torch.accel import traverse_pallas as TPL
    from hydracore3_torch.accel import traverse_stream as TST
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.models import megakernel as MK
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    import zoo_scenes as Z
    t21 = time.perf_counter()

    def at(msg):
        log(f'  {msg} ({time.perf_counter() - t21:.1f} s into phase 21)')

    def launched():
        return {w_.__name__: w_.launches for w_ in counters}

    names = ('intersect_clusters_motion_kernel<nearest>',
             'intersect_clusters_motion_kernel<any-hit>')
    attrs = TST.kernel_attrs()
    cattrs = TST.kernel_attrs(count_lib)
    log('[21] the moving soup (accel=\'bvh\'), K5m: ' + ', '.join(
        f'{k} {attrs[k][0]} registers {attrs[k][1]} local bytes'
        for k in names) + '; of its counting build ' + ', '.join(
        f'{k} {cattrs[k]}' for k in names))
    rec = dict(registers={k: attrs[k] for k in names})
    soups, twins = {}, {}
    for label, path in (('motion box', paths[0]), ('motion city', paths[1])):
        t0 = time.perf_counter()
        sc, mt = B.load_scene(path, device=dev, accel='bvh')
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        w = sc.cl_wide
        log(f'  {label} {mt.width}x{mt.height} under accel=\'bvh\': '
            f'{mt.num_tris} triangles, moving '
            f'{int((sc.tri_dv0 != 0).any(1).sum())}; use_bvh {mt.use_bvh}, '
            f'use_pallas {mt.use_pallas}, use_two_level '
            f'{mt.use_two_level}; the kernel\'s table: {w.nodes.shape[0]} '
            f'wide nodes, stack {w.stack}, margin {w.margin:.3e}, '
            f'{nbytes(*w.tensors().values()) / 2**20:.2f} MiB; loaded in '
            f'{load_s:.2f} s; K1 gate: {MK.why_unsupported(sc, mt)}')
        check(mt.has_motion and not mt.use_two_level and not mt.use_stream
              and w.drows is not None and not R.use_megakernel(sc, mt),
              f'{label}: not a moving soup under accel=\'bvh\'')
        soups[label] = (sc, mt)
        twins[label] = B.load_scene(path, device=dev)
    at('the moving soups and their two-level twins loaded')

    def lanes(label, sc, mt, queries, n_plain=None):
        """K5m against its plain version on every lane of ``queries`` (the
        first ``n_plain`` lanes only, if given), each at its lanes' times,
        timed, counted and bounded at full width."""
        n = mt.width * mt.height
        pix = torch.arange(n, device=dev)
        tm_ = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix).time
        mo = IPT.soup_motion(sc, tm_)
        tabs = tuple(sc.cl_wide.tensors().values()) + (tm_,)
        out = {}
        for qlabel, q, any_hit in queries:
            def run(q=q, any_hit=any_hit):
                return TPL.intersect_clusters(None, None, sc.cl_tris12, *q,
                                              any_hit=any_hit,
                                              wide=sc.cl_wide, motion=mo)
            k = run()
            sub = slice(None) if n_plain is None else slice(0, n_plain)
            qs = tuple(x[sub] for x in q)
            mos = mo[:3] + (mo[3][sub],)
            p, p_ms = timed(lambda: TPL.intersect_clusters_plain(
                sc.cl_tris12, *qs, any_hit, mos))
            ks = tuple(x[sub] for x in k)
            flags_eq = bool(torch.equal(ks[1] >= 0, p[1] >= 0))
            if any_hit:
                valid = TPL.occluder_valid(sc.cl_tris12, ks[1], *qs, mos)
                ok = flags_eq and bool(torch.equal(valid, ks[1] >= 0))
                err = 0.0
                detail = 'reported triangles occlude their lanes'
            else:
                ok = flags_eq and all(bool(torch.equal(a, b))
                                      for a, b in zip(ks, p))
                both = (ks[1] >= 0) & (p[1] >= 0)
                err = float((ks[0] - p[0])[both].abs().max()) \
                    if bool(both.any()) else 0.0
                detail = (f'{int((ks[1] != p[1]).sum())} lanes with another '
                          'triangle')
            k_ms = cuda_ms(run, 10)
            b = query_counts('intersect_clusters_motion', f'{label} {qlabel}',
                             run, tabs, MT_OPS + LERP_OPS, n=n)
            log(f'  K5m {label} {qlabel}: hits {int((k[1] >= 0).sum())}/{n}; '
                f'{ks[1].numel()} lanes against the plain version: hit flags '
                f'equal {flags_eq}, {detail}; kernel {k_ms:.3f} ms at full '
                f'width, plain {p_ms:.3f} ms on {ks[1].numel()} lanes')
            check(ok, f'K5m {label} {qlabel}: lanes unlike the plain version')
            out[qlabel] = dict(ms=k_ms, plain_ms=p_ms, plain_lanes=int(
                ks[1].numel()), bound_ms=b[0], bound_by=b[1], counts=b[2],
                max_abs_err=err)
        return out

    sc, mt = soups['motion box']
    cam, shadow, bounce, traced = first_bounce_queries(sc, mt)
    rec['motion_box'] = lanes('motion box', sc, mt, (
        ('camera nearest', cam, False), ('shadow any-hit', shadow, True),
        ('bounce nearest', bounce, False)))
    del cam, shadow, bounce
    sc, mt = soups['motion city']
    cam = first_bounce_queries(sc, mt)[0]
    rec['motion_city'] = lanes('motion city', sc, mt,
                               (('camera nearest', cam, False),),
                               TESS_LANES)
    del cam
    at('K5m\'s queries checked')

    # the full-frame moving soups against their two-level twins, same seeds
    rec['launches'] = 0
    for label in ('motion box', 'motion city'):
        key = label.replace(' ', '_')
        imgs = {}
        for route, (sc, mt) in (('bvh', soups[label]),
                                ('two-level', twins[label])):
            zero_counts()
            im, tm = R.render(sc, mt, spp=RATE_SPP, integrator='mispt',
                              tile_size=1 << 20, return_timing=True)
            n_l = launched()
            rate = mt.width * mt.height * RATE_SPP / tm['total_s'] / 1e6
            log(f'  render {label} ({route}) mispt {RATE_SPP} spp: '
                f'{tm["total_s"]:.2f} s, {rate:.4f} Msamples/s, launches '
                f'{ {k: v for k, v in n_l.items() if v} }, non-finite lane '
                f'samples {tm["nonfinite"]}')
            wrapper = ('intersect_clusters_motion' if route == 'bvh'
                       else 'intersect_two_level')
            check(n_l[wrapper] > 0 and n_l['sample_pass'] == 0
                  and n_l['regen_pass'] == 0 and tm['nonfinite'] == 0
                  and np.isfinite(im).all()
                  and (route != 'bvh' or n_l['intersect_two_level'] == 0),
                  f'{label} ({route}): launches {n_l}')
            imgs[route] = (im, tm['total_s'], n_l[wrapper])
        im, im2 = imgs['bvh'][0], imgs['two-level'][0]
        p_t, m_t = psnr_mean(im, im2[..., :3])
        log(f'  {label}: the moving soup against its two-level twin at the '
            f'same seeds: PSNR {p_t:.2f} dB, mean {100 * m_t:.4f}% off')
        check(p_t >= SOUP_TWIN_PSNR and m_t <= SOUP_TWIN_MEAN,
              f'{label}: soup vs two-level {p_t:.2f} dB, mean '
              f'{100 * m_t:.4f}% off')
        rec[key].update(seconds=imgs['bvh'][1],
                        twin_seconds=imgs['two-level'][1],
                        launches=imgs['bvh'][2], twin_db=p_t,
                        twin_mean=m_t)
        rec['launches'] += imgs['bvh'][2]
        del imgs, im, im2
    at('the full-frame renders checked')

    # the motion box at the golden's size and seeds (JAX 'bvh')
    gold = np.load(Z.golden_path('soup_motion_box_mispt_128.npz'))
    gh, gw = gold['early'].shape[:2]
    scg, mtg = golden_size(*soups['motion box'], gw, gh)
    early = int(gold['early_spp'])
    zero_counts()
    ig, tg = R.render(scg, mtg, spp=early, integrator='mispt',
                      return_timing=True)
    n_g = launched()
    pg, mg = psnr_mean(ig, gold['early'])
    near = float((np.abs(ig[..., :3] - gold['early']).max(-1)
                  <= 1e-3).mean())
    log(f'  render motion box (bvh) {gw}x{gh} {early} spp (the golden\'s '
        f'size, seeds and first samples): PSNR {pg:.2f} dB, mean '
        f'{100 * mg:.5f}% off, {near:.6f} of the pixels within 1e-3, '
        f'launches { {k: v for k, v in n_g.items() if v} }, non-finite lane '
        f'samples {tg["nonfinite"]}')
    check(pg >= MOTION_SEED_PSNR and near >= MOTION_SEED_PIXELS
          and tg['nonfinite'] == 0 and n_g['intersect_clusters_motion'] > 0
          and n_g['sample_pass'] == 0 and n_g['regen_pass'] == 0,
          f'motion box (bvh) at the golden\'s size off the golden: '
          f'{pg:.2f} dB, {near:.6f} of the pixels within 1e-3, launches '
          f'{n_g}')
    rec['motion_box'].update(seeds_db=pg, seeds_pixels_near=near)
    rec['seconds'] = time.perf_counter() - t21
    log(f'  phase 21: {rec["seconds"]:.1f} s')
    return rec


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
    from hydracore3_torch.accel import two_level as TL2
    from hydracore3_torch.accel import wide_bvh as WB
    from hydracore3_torch.models import integrator_pt as IPT
    from hydracore3_torch.models import megakernel as MK
    from hydracore3_torch.ops import rng as RNG
    from hydracore3_torch.scene import build as B
    from hydracore3_torch.scene import synth

    dev = torch.device('cuda:0')
    t_start = time.perf_counter()
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
    # one nvcc per source and K1 variant, started together: K1's GLTF-only
    # MIS variant (phases 5, 5b, 9) and the zoo box's three (phase 10), each
    # with its counting build
    zoo_bits = MK.material_bits(tuple(MK.MT_BITS), has_disc=True)
    zoo_variants = [(MK.INTEGRATOR_BY_NAME[n], zoo_bits, True)
                    for n in ZOO_INT]
    # and the spectral box's three spectral variants (phase 14)
    spec_bits = MK.material_bits((MK.MAT_TYPE_GLTF, MK.MAT_TYPE_DIFFUSE,
                                  MK.MAT_TYPE_CONDUCTOR), has_disc=True)
    spec_variants = [(MK.INTEGRATOR_BY_NAME[n], spec_bits, False, True)
                     for n in ZOO_INT]
    k1_variants = [MK.DEFAULT_VARIANT] + zoo_variants + spec_variants
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2 + 2 * len(k1_variants)) \
            as pool:
        tjobs = [pool.submit(TST.build_kernels),
                 pool.submit(TST.load_library, ('HC3_COUNT',))]
        kjobs = {v: pool.submit(MK.build_kernels, v) for v in k1_variants}
        cjobs = {v: pool.submit(MK.load_library, MK.variant_defines(v)
                                + ('HC3_COUNT',)) for v in k1_variants}
        build_s = tjobs[0].result()
        count_lib, count_s = tjobs[1].result()
        k1_s = {v: j.result() for v, j in kjobs.items()}
        mega_count = {v: j.result() for v, j in cjobs.items()}
    log(f'[1] kernels built from hydracore3_torch/csrc/traverse.cu '
        f'({build_s:.2f} s; its counting build {count_s:.2f} s) and '
        f'csrc/megakernel.cu, {len(k1_variants)} variants and the counting '
        f'build of each ({max(k1_s.values()):.2f} s, '
        f'{max(c[1] for c in mega_count.values()):.2f} s at most) in '
        f'{time.perf_counter() - t0:.2f} s')
    for v in k1_variants:
        log(f'  K1 variant (integrator, material bits, env tap[, '
            f'spectral]) {v}: '
            f'{MK.kernel_attrs(MK.kernel_library(v))}; of its counting '
            f'build {MK.kernel_attrs(mega_count[v][0])}')
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

    def query_counts(name, label, run, tables, tri_ops, n=N,
                     inst_ops=XFORM_OPS):
        """One counted launch of a query: its tests per ray and the bound
        they set; ``tables`` are what the kernel reads, and the outputs
        count at the size the kernel writes them (int64 indices)."""
        with counted(TST, count_lib) as c:
            out = run()
        b = ray_query_bound(c, n, nbytes(*out) / (4 * n), tables,
                            tri_ops=tri_ops, inst_ops=inst_ops)
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
    city4 = dict(seconds=timing['total_s'], launches=dict(launches))
    psnr, mean_rel = psnr_mean(img, gold)
    log(f'  PSNR vs golden {psnr:.2f} dB; mean {100 * mean_rel:.3f}% off')
    if psnr < PSNR_MIN or mean_rel > MEAN_TOL:
        raise RuntimeError(f'image off the golden: PSNR {psnr:.2f} dB, mean '
                           f'{100 * mean_rel:.3f}% off')

    # ---- 5. the box through the megakernel (K1); 5b. the tessellated box --
    gold_box = np.load(os.path.join(REPO, 'tests', 'goldens',
                                    'box_1024x768_128.npz'))['img']

    def k1_counted(run, variant=MK.DEFAULT_VARIANT):
        """What one K1 launch's lanes did, by the counting build of
        csrc/megakernel.cu (-DHC3_COUNT) of ``variant``: Woop tests,
        child-box tests, then shades by material kind (SHADE_KINDS)."""
        lib = mega_count[variant][0]
        shipped = MK._lib
        TST.launch_checked('hc3_mega_counts_reset',
                           lib.hc3_mega_counts_reset())
        MK._lib = lib
        try:
            run()
        finally:
            MK._lib = shipped
        torch.cuda.synchronize()
        buf = (ctypes.c_uint64 * (2 + len(SHADE_KINDS)))()
        TST.launch_checked('hc3_mega_counts_read',
                           lib.hc3_mega_counts_read(buf))
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
        log(f'  K1 at this pack: {layout_line(MK.kernel_attrs(pk=pk))}')
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
            cnt = k1_counted(run)
            woop_t, slab_t, shades = cnt[0], cnt[1], sum(cnt[2:])
            ops = woop_t * WOOP_OPS + slab_t * SLAB_OPS + shade_ops(cnt)
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
                MK.sample_pass, MK.regen_pass, TL2.intersect_two_level,
                TPL.intersect_clusters_motion)

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
        cx = None if mt.has_blend else IPT.MAT.make_shading_ctx(
            sc, mt, IPT._extract_mat_id(stt.flags), stt.hit_norm,
            stt.hit_tang, stt.hit_uv)
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
        'two-level', tl_scene, tl_meta, TT.intersect_stream_tlas, RATE_SPP)
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
                                    TDD.intersect_march, RATE_SPP)
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
            f'K5 intersect_clusters {label}', k7, plain7, any_hit,
            exact=True))
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
        'cluster route', cl_scene, cl_meta, TPL.intersect_clusters, RATE_SPP)
    del cl_scene
    st_scene, st_meta = synth.city_scene(**MID, accel='stream', device=dev)
    st_img, _, _ = render_checked('streamed', st_scene, st_meta,
                                  TDD.intersect_march, RATE_SPP)
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
    # the city's library stays until phase 18 (the command line's input)
    libs_dir = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as tmp:
        box_dir = os.path.join(tmp, 'box')
        city_dir = os.path.join(libs_dir.name, 'city')
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

    # ---- 10. the material zoo box through K1 -----------------------------
    # tests/zoo_scenes.py: the textured box plus a rough and a smooth
    # conductor, a Lambert and an Oren-Nayar diffuse, a dielectric cube, an
    # old-Hydra glass cube, a disc light and an 8-bit lat-long sky; each
    # integrator through its K1 variant, held against the plain version on
    # every lane of a full frame, timed and counted, rendered with both
    # entry points against the JAX goldens and against the same box on the
    # batched streamed route
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import zoo_scenes
    with tempfile.TemporaryDirectory() as tmp:
        zpath = zoo_scenes.write_zoo_box(tmp, 1024, 768, 6)
        zoo, zmeta = B.load_scene(zpath, device=dev)
        ztwin, ztmeta = B.load_scene(zpath, device=dev, accel='stream')
    zpk = MK.pack(zoo, zmeta)
    zxy, zsu = MK.lane_setup(zmeta, dev)
    zn, zdepth, it = zxy.shape[1], zmeta.trace_depth, MK.REGEN_ITERS
    log(f'[10] the zoo box {zmeta.width}x{zmeta.height}: {zmeta.num_tris} '
        f'triangles, material types {zmeta.mat_types_present}, lights '
        f'{zmeta.light_geom_types}, env map {zmeta.has_env_map} (sampled '
        f'{zmeta.env_enable_sam}), depth {zdepth}, {zn} lanes; K1 gate: '
        f'{MK.why_unsupported(zoo, zmeta)}; the twin use_stream '
        f'{ztmeta.use_stream}')
    check(MK.supported(zoo, zmeta) and not zmeta.use_stream
          and ztmeta.use_stream, 'the zoo box is not routed to K1, or its '
          'twin not streamed')
    ztables = (zpk.wide.nodes, zpk.wide.rows, zpk.wide.index, zpk.shade,
               zpk.mat, zpk.light, zpk.tex, zpk.consts, zpk.texels)
    zoo_rec = {}
    for name in ZOO_INT:
        itype = MK.INTEGRATOR_BY_NAME[name]
        var = MK.variant_of(zpk, itype)
        attrs = MK.kernel_attrs(MK.kernel_library(var), zpk)
        rec = dict(variant=list(var), registers={
            k: (a['registers'], a['local_bytes']) for k, a in attrs.items()})
        log(f'  {name}, K1 at this pack: {layout_line(attrs)}')
        # every lane of a full frame against the plain version
        k_f = MK.sample_pass(zpk, zxy, zsu, zdepth, itype)
        p_f, p_ms = timed(lambda: MK.sample_pass_plain(zpk, zxy, zsu, zdepth,
                                                       itype))
        c, e, err_f = MK.lanes_agree(k_f, p_f, 3)
        nonfin = int((~torch.isfinite(k_f[0])).any(0).sum())
        log(f'  {name}, K1 variant {var}, registers / local bytes '
            f'{rec["registers"]}: fixed chain, {zn} lanes close {c:.6f}, '
            f'RNG/flags equal {e:.6f}, max|d| {err_f:.3e}, non-finite lane '
            f'samples {nonfin}')
        check(c == 1.0 and e == 1.0 and nonfin == 0,
              f'zoo {name} fixed chain: {c} / {e} of lanes agree, {nonfin} '
              'non-finite')
        del k_f, p_f
        sf, sr = MK.regen_pass(zpk, zxy, None, zsu, it, zdepth, first=True,
                               integrator=itype)
        k_r = MK.regen_pass(zpk, zxy, sf, sr, it, zdepth, integrator=itype)
        sfp, srp = MK.regen_iters_plain(zpk, zxy, None, zsu, it, zdepth,
                                        first=True, integrator=itype)
        p_r, p_ms_r = timed(lambda: MK.regen_iters_plain(
            zpk, zxy, sfp, srp, it, zdepth, integrator=itype))
        c, e, err_r = MK.lanes_agree(k_r, p_r, MK.RU_NROWS)
        log(f'  {name}: regen ({it} iterations after rfirst + {it - 1}), '
            f'close {c:.6f}, RNG/flags/counts equal {e:.6f}, max|d| '
            f'{err_r:.3e}')
        check(c == 1.0 and e == 1.0,
              f'zoo {name} regen: {c} / {e} of lanes agree')
        del k_r, p_r, sfp, srp
        errs['mega_sample'] = max(errs['mega_sample'], err_f)
        errs['mega_regen'] = max(errs['mega_regen'], err_r)
        for kname, run, io, pms in (
                ('mega_sample', lambda: MK.sample_pass(zpk, zxy, zsu, zdepth,
                                                       itype), 64 * zn, p_ms),
                ('mega_regen', lambda: MK.regen_pass(
                    zpk, zxy, sf, sr, it, zdepth, integrator=itype),
                 328 * zn, p_ms_r)):
            k_ms = cuda_ms(run, 10)
            cnt = k1_counted(run, var)
            ops = (cnt[0] * WOOP_OPS + cnt[1] * SLAB_OPS
                   + shade_ops(cnt, naive=itype == MK.INTEGRATOR_STUPID_PT))
            b = bound(io + nbytes(*ztables), ops)
            per = ', '.join(f'{k} {x / zn:.3f}' for k, x in
                            zip(SHADE_KINDS, cnt[2:]))
            log(f'  {name} {kname}: {k_ms:.3f} ms per '
                f'{"pass" if kname == "mega_sample" else "launch"}; plain '
                f'{pms:.3f} ms; per lane {cnt[0] / zn:.3f} Woop, '
                f'{cnt[1] / zn:.3f} child-box tests, shades {per}; bound '
                f'{b[0]:.4f} ms by {b[1]} ({k_ms / b[0]:.1f}x above)')
            rec[kname] = dict(ms=k_ms, plain_ms=pms, bound_ms=b[0],
                              bound_by=b[1], operations=ops)
        # the renders, the counts at 0 just before each
        gold_z = np.load(zoo_scenes.golden_path(
            f'zoo_box_{name}_128.npz'))['img']
        imgs = {}
        for kname, regen in (('mega_sample', False), ('mega_regen', True)):
            zero_counts()
            img, tm = R.render(zoo, zmeta, spp=BOX_SPP, integrator=name,
                               regen=regen, return_timing=True)
            n_l = (MK.regen_pass if regen else MK.sample_pass).launches
            others = {w_.__name__: w_.launches for w_ in counters
                      if w_ not in (MK.sample_pass, MK.regen_pass)}
            samples = tm.get('samples', zmeta.width * zmeta.height * BOX_SPP)
            p, m_ = psnr_mean(img, gold_z)
            rate = samples / tm['total_s'] / 1e6
            log(f'  {name} render {"regen" if regen else "fixed"} {BOX_SPP} '
                f'spp: {tm["total_s"]:.3f} s, {rate:.2f} Msamples/s, '
                f'launches {n_l} (other kernels {others}), non-finite lane '
                f'samples {tm["nonfinite"]}; vs JAX golden PSNR {p:.2f} dB, '
                f'mean {100 * m_:.3f}% off')
            check(n_l > 0 and not any(others.values()),
                  f'zoo {name} {kname}: K1 launches {n_l}, others {others}')
            check(tm['nonfinite'] == 0 and np.isfinite(img).all(),
                  f'zoo {name} {kname}: non-finite samples')
            check(p >= ZOO_PSNR[name] and m_ <= ZOO_MEAN[name],
                  f'zoo {name} {kname} off the golden: {p:.2f} dB, mean '
                  f'{100 * m_:.3f}% off')
            rec[kname].update(launches=n_l, msamples_s=rate, psnr=p,
                              mean_off=m_)
            imgs[kname] = img[..., :3]
        small = imgs['mega_sample'].reshape(96, 8, 128, 8, 3).mean((1, 3))
        p_rf, _ = psnr_mean(imgs['mega_regen'], small)
        zero_counts()
        twin, tmt = R.render(ztwin, ztmeta, spp=ZOO_TWIN_SPP,
                             integrator=name, tile_size=1 << 20,
                             return_timing=True)
        n_tw = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                     TDD.intersect_march)}
        p_tw, m_tw = psnr_mean(twin, small)
        log(f'  {name}: regen vs fixed chain PSNR {p_rf:.2f} dB (8x box '
            f'means); the streamed batched twin at {ZOO_TWIN_SPP} spp: '
            f'{tmt["total_s"]:.2f} s, launches {n_tw}, non-finite '
            f'{tmt["nonfinite"]}; K1 vs twin PSNR {p_tw:.2f} dB, mean '
            f'{100 * m_tw:.3f}% off (8x box means)')
        check(p_rf >= REGEN_PSNR_MIN, f'zoo {name}: regen vs fixed '
              f'{p_rf:.2f} dB')
        check(p_tw >= REGEN_PSNR_MIN and tmt['nonfinite'] == 0
              and streamed_launched(n_tw, itype), f'zoo {name}: K1 vs its '
              f'batched twin {p_tw:.2f} dB, launches {n_tw}')
        rec.update(regen_vs_fixed_db=p_rf, vs_twin_db=p_tw)
        zoo_rec[name] = rec
    del zoo, ztwin, zpk

    # ---- 11. the zoo city through K2/K3 -----------------------------------
    # the bench city with its walls an Oren-Nayar diffuse, a rough
    # conductor, a dielectric and an old-Hydra glass: K2/K3 on its sorted
    # first-bounce (refracted lanes among them) and shadow queries against
    # the dense plain version on every lane, then each integrator's render
    with tempfile.TemporaryDirectory() as tmp:
        zpath = zoo_scenes.write_zoo_city(tmp, width=1024, height=1024,
                                          depth=5, textured=True)
        zc, zcm = B.load_scene(zpath, device=dev)
        gsize = zcm.width // 8
        zs, zsm = B.load_scene(zpath, device=dev, width=gsize, height=gsize)
    cn = zcm.width * zcm.height
    log(f'[11] the zoo city {zcm.width}x{zcm.height}: material types '
        f'{zcm.mat_types_present}, use_stream {zcm.use_stream}')
    _, shadow, bounce, n_sh = first_bounce_queries(zc, zcm)
    pix = torch.arange(cn, device=dev)
    stz = IPT.kernel_init_eye_ray(zc, zcm, RNG.gen_init(pix), pix)
    stz = IPT.kernel_ray_trace(zc, zcm, stz, 0)
    cz = IPT.MAT.make_shading_ctx(zc, zcm, IPT._extract_mat_id(stz.flags),
                                  stz.hit_norm, stz.hit_tang, stz.hit_uv)
    shz, rz = IPT.kernel_sample_light_source(zc, zcm, stz, cz)
    stz = IPT.kernel_next_bounce(zc, zcm, stz._replace(rng=rz), 0, shz, cz)
    n_refr = int((((stz.flags & IPT.C.RAY_EVENT_T) != 0)
                  & ~IPT._is_dead(stz.flags)).sum())
    del stz, cz, shz
    log(f'  first bounce: {n_refr} live lanes refracted, {n_sh} shadow rays '
        'traced')
    check(n_refr > 0, 'no refracted lane on the zoo city')
    zstream = lambda *q, **kw: TST.intersect_stream(  # noqa: E731
        zc.st_nodes_f, zc.st_nodes_i, zc.st_woop, *q, wide=zc.st_wide, **kw)
    zmarch = lambda *q: TDD.intersect_march(  # noqa: E731
        zc.st_grid, zc.st_woop, *q, with_unresolved=True, wide=zc.st_wide)
    from hydracore3_torch.accel.traverse_stream import hits_agree
    # (its camera query is phase 3's: the same rays on the same triangles)
    for label, q, any_hit in (('first bounce', bounce, False),
                              ('shadow', shadow, True)):
        plain_q = TST.intersect_plain(zc.st_woop, *q[:3], torch.clamp(
            q[3], max=0.99 * TST.FLT_MAX), any_hit=any_hit)
        outs = [('K2', zstream(*q, any_hit=any_hit))]
        if not any_hit:
            *km, un = zmarch(*q)
            outs.append(('K3', km))
            check(int(un.sum()) == 0, f'zoo city {label}: {int(un.sum())} '
                  'unresolved march lanes')
        for kname, out in outs:
            a = hits_agree(out, plain_q, any_hit)
            log(f'  {kname} {label}: lanes with another hit flag '
                f'{a["hit_diff"]}, another triangle {a["tri_diff"]} '
                f'({a["tie_diff"]} at equal t), max|dt| {a["max_dt"]:.3e}, '
                f'max|du|,|dv| {a["max_duv"]:.3e}')
            check(a['hit_diff'] == 0 and a['tri_diff'] == 0
                  and a['max_duv'] <= UV_TOL,
                  f'zoo city {kname} {label}: {a["hit_diff"]} / '
                  f'{a["tri_diff"]} lanes unlike the plain version')
    del shadow, bounce
    gold_c = np.load(zoo_scenes.golden_path('zoo_city_mispt_128.npz'))
    gold_spp, gold_c = int(gold_c['spp']), gold_c['img']
    zero_counts()
    im, tm = R.render(zs, zsm, spp=gold_spp, integrator='mispt',
                      tile_size=1 << 20, return_timing=True)
    n11 = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                TDD.intersect_march)}
    p_s, m_s = psnr_mean(im, gold_c)
    log(f'  render mispt {gsize}x{gsize} {gold_spp} spp (the golden\'s size, '
        f'samples and seeds): vs JAX golden PSNR {p_s:.2f} dB, mean '
        f'{100 * m_s:.5f}% off, launches {n11}, non-finite lane samples '
        f'{tm["nonfinite"]}')
    check(p_s >= CITY_ZOO_SMALL_PSNR and m_s <= CITY_ZOO_SMALL_MEAN
          and tm['nonfinite'] == 0
          and streamed_launched(n11, MK.INTEGRATOR_BY_NAME['mispt']),
          f'zoo city at the golden\'s size off the golden: {p_s:.2f} dB, '
          f'mean {100 * m_s:.5f}% off, launches {n11}')
    del zs
    for name in ZOO_INT:
        zero_counts()
        spp11 = spp if name == 'mispt' else RATE_SPP
        im, tm = R.render(zc, zcm, spp=spp11, integrator=name,
                          tile_size=1 << 20, return_timing=True)
        n11 = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                    TDD.intersect_march)}
        rate = cn * spp11 / tm['total_s'] / 1e6
        line = (f'  render {name} {spp11} spp: {tm["total_s"]:.2f} s, '
                f'{rate:.4f} Msamples/s, launches {n11}, non-finite lane '
                f'samples {tm["nonfinite"]}')
        if name == 'mispt':
            p, m_ = psnr_mean(im, gold_c)
            line += f'; vs JAX golden PSNR {p:.2f} dB, mean {100 * m_:.3f}% off'
            check(p >= CITY_ZOO_PSNR and m_ <= CITY_ZOO_MEAN,
                  f'zoo city off the golden: {p:.2f} dB, mean '
                  f'{100 * m_:.3f}% off')
        log(line)
        check(streamed_launched(n11, MK.INTEGRATOR_BY_NAME[name])
              and tm['nonfinite'] == 0 and np.isfinite(im).all(),
              f'zoo city {name}: launches {n11}, {tm["nonfinite"]} '
              'non-finite samples')
    del zc

    # ---- 12. the zoo box II through the batched route (K5) -----------------
    # tests/zoo_scenes.py: the zoo box's shell with a rough and a smooth
    # nonlinear plastic, a transparent, a rough metal-substrate and a
    # thickness-mapped thin film, a blend of a blend and a float-textured
    # sky.  K1 refuses it, so 'auto' sends it to the batched integrator,
    # which traces it through K5 over the small class's rows
    with tempfile.TemporaryDirectory() as tmp:
        zpath = zoo_scenes.write_zoo_box2(tmp, 1024, 768, 6)
        z2, z2m = B.load_scene(zpath, device=dev)
        z2s, z2sm = B.load_scene(zpath, device=dev, accel='stream')
        gold2 = {n: np.load(zoo_scenes.golden_path(f'zoo_box2_{n}_128.npz'))
                 for n in ZOO_INT}
        gw, gh = gold2['mispt']['img'].shape[1], gold2['mispt']['img'].shape[0]
        z2g, z2gm = B.load_scene(zpath, device=dev, width=gw, height=gh)
    n2 = z2m.width * z2m.height
    wide12 = tuple(z2.cl_wide.tensors().values())
    log(f'[12] the zoo box II {z2m.width}x{z2m.height}: {z2m.num_tris} '
        f'triangles, material types {z2m.mat_types_present}, env sampled '
        f'{z2m.env_enable_sam}, blend descent rounds '
        f'{z2m.blend_sample_rounds}, eval steps {len(z2m.blend_eval_types)}; '
        f'K1 gate: {MK.why_unsupported(z2, z2m)}; cl_wide '
        f'{z2.cl_wide.nodes.shape[0]} wide nodes, stack {z2.cl_wide.stack}')
    check(not any(R.use_megakernel(z2, z2m, n) for n in ZOO_INT)
          and not (z2m.use_stream or z2m.use_pallas or z2m.use_stream_tlas)
          and z2sm.use_stream, 'the zoo box II is routed to K1, or is not '
          'small, or its twin not streamed')
    small = lambda *q, **kw: TPL.intersect_clusters(  # noqa: E731
        None, None, z2.cl_tris12, *q, wide=z2.cl_wide, **kw)
    cam12, shadow12, bounce12, traced12 = first_bounce_queries(z2, z2m)
    rec12 = dict(launches={})
    for label, q, any_hit in (('camera nearest', cam12, False),
                              ('shadow any-hit', shadow12, True),
                              ('bounce nearest', bounce12, False)):
        p12, p_ms = timed(lambda: TPL.intersect_clusters_plain(
            z2.cl_tris12, *q, any_hit))
        k12 = small(*q, any_hit=any_hit)
        dt = compare(f'K5 intersect_clusters zoo box II {label}', k12, p12,
                     any_hit, exact=True)
        errs['intersect_clusters'] = max(errs['intersect_clusters'], dt)
        if any_hit:
            occ = k12[1] >= 0
            valid = TPL.occluder_valid(z2.cl_tris12, k12[1], *q)
            check(bool((valid == occ).all()), 'zoo box II K5 any-hit '
                  'reported a triangle that does not occlude its lane')
        k_ms = cuda_ms(lambda: small(*q, any_hit=any_hit), 10)
        b12 = query_counts('intersect_clusters', f'zoo box II {label}',
                           lambda: small(*q, any_hit=any_hit), wide12,
                           MT_OPS, n=n2)
        log(f'  {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms')
        rec12[label] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b12[0],
                            bound_by=b12[1], max_abs_err=dt)
    log(f'  shadow: {traced12} traced rays')
    del p12, k12, cam12, shadow12, bounce12
    img12 = {}
    for name in ZOO_INT:
        itype = MK.INTEGRATOR_BY_NAME[name]
        zero_counts()
        spp12 = ZOO_TWIN_SPP if name == 'mispt' else RATE_SPP
        im, tm = R.render(z2, z2m, spp=spp12, integrator=name,
                          tile_size=1 << 20, return_timing=True)
        n12 = {w_.__name__: w_.launches for w_ in counters}
        rate = n2 * spp12 / tm['total_s'] / 1e6
        p, m_ = psnr_mean(im, gold2[name]['img'])
        log(f'  render {name} {spp12} spp: {tm["total_s"]:.2f} s, '
            f'{rate:.4f} Msamples/s, launches {n12}, non-finite lane samples '
            f'{tm["nonfinite"]}; vs the {int(gold2[name]["spp"])}-sample '
            f'golden PSNR {p:.2f} dB, mean {100 * m_:.3f}% off')
        check(n12['intersect_clusters'] > 0 and n12['sample_pass'] == 0
              and n12['regen_pass'] == 0 and tm['nonfinite'] == 0
              and np.isfinite(im).all(), f'zoo box II {name}: launches '
              f'{n12}, {tm["nonfinite"]} non-finite samples')
        rec12['launches'][name] = n12['intersect_clusters']
        rec12[name] = dict(msamples_s=rate, nonfinite=tm['nonfinite'])
        img12[name] = im[..., :3]
        # the golden's size and seeds, its first samples: the same streams
        early = int(gold2[name]['early_spp'])
        zero_counts()
        ig, tg = R.render(z2g, z2gm, spp=early, integrator=name,
                          return_timing=True)
        pg, mg = psnr_mean(ig, gold2[name]['early'])
        log(f'  render {name} {gw}x{gh} {early} spp (the golden\'s size, '
            f'seeds and first samples): PSNR {pg:.2f} dB, mean '
            f'{100 * mg:.5f}% off, K5 launches '
            f'{TPL.intersect_clusters.launches}, non-finite lane samples '
            f'{tg["nonfinite"]}')
        check(pg >= CITY_ZOO_SMALL_PSNR and tg['nonfinite'] == 0,
              f'zoo box II {name} at the golden\'s size off the golden: '
              f'{pg:.2f} dB')
        rec12[name]['golden_db'] = pg
    del z2g
    zero_counts()
    im_s, tm_s = R.render(z2s, z2sm, spp=ZOO_TWIN_SPP, integrator='mispt',
                          tile_size=1 << 20, return_timing=True)
    n_s = {w_.__name__: w_.launches for w_ in counters}
    p_s, m_s = psnr_mean(im_s, img12['mispt'])
    log(f'  the streamed twin (K2/K3) mispt {ZOO_TWIN_SPP} spp: '
        f'{tm_s["total_s"]:.2f} s, launches {n_s}; vs the auto route PSNR '
        f'{p_s:.2f} dB, mean {100 * m_s:.3f}% off')
    check(p_s >= PSNR_MIN and streamed_launched(n_s, 2)
          and tm_s['nonfinite'] == 0, f'zoo box II streamed twin vs auto '
          f'{p_s:.2f} dB, launches {n_s}')
    launches['intersect_clusters'] += rec12['launches']['mispt']
    del z2, z2s, img12, im_s

    # ---- 13. the zoo city II through K2/K3 ----------------------------------
    # the bench city with its walls a textured Oren-Nayar diffuse, a rough
    # plastic, a rough metal-substrate thin film and a blend (the facade
    # texture weighing a diffuse against a rough conductor)
    with tempfile.TemporaryDirectory() as tmp:
        zpath = zoo_scenes.write_zoo_city2(tmp, width=1024, height=1024,
                                           depth=5, textured=True)
        zc, zcm = B.load_scene(zpath, device=dev)
        gold_c2 = np.load(zoo_scenes.golden_path('zoo_city2_mispt_128.npz'))
        gsize = gold_c2['img'].shape[0]
        zs, zsm = B.load_scene(zpath, device=dev, width=gsize, height=gsize)
    log(f'[13] the zoo city II {zcm.width}x{zcm.height}: material types '
        f'{zcm.mat_types_present}, use_stream {zcm.use_stream}, blend eval '
        f'steps {len(zcm.blend_eval_types)}')
    _, shadow, bounce, n_sh = first_bounce_queries(zc, zcm)
    zstream = lambda *q, **kw: TST.intersect_stream(  # noqa: E731
        zc.st_nodes_f, zc.st_nodes_i, zc.st_woop, *q, wide=zc.st_wide, **kw)
    zmarch = lambda *q: TDD.intersect_march(  # noqa: E731
        zc.st_grid, zc.st_woop, *q, with_unresolved=True, wide=zc.st_wide)
    for label, q, any_hit in (('first bounce', bounce, False),
                              ('shadow', shadow, True)):
        plain_q = TST.intersect_plain(zc.st_woop, *q[:3], torch.clamp(
            q[3], max=0.99 * TST.FLT_MAX), any_hit=any_hit)
        outs = [('K2', zstream(*q, any_hit=any_hit))]
        if not any_hit:
            *km, un = zmarch(*q)
            outs.append(('K3', km))
            check(int(un.sum()) == 0, f'zoo city II {label}: '
                  f'{int(un.sum())} unresolved march lanes')
        for kname, out in outs:
            a = hits_agree(out, plain_q, any_hit)
            log(f'  {kname} {label}: lanes with another hit flag '
                f'{a["hit_diff"]}, another triangle {a["tri_diff"]} '
                f'({a["tie_diff"]} at equal t), max|dt| {a["max_dt"]:.3e}, '
                f'max|du|,|dv| {a["max_duv"]:.3e}')
            check(a['hit_diff'] == 0 and a['tri_diff'] == 0
                  and a['max_duv'] <= UV_TOL,
                  f'zoo city II {kname} {label}: {a["hit_diff"]} / '
                  f'{a["tri_diff"]} lanes unlike the plain version')
    log(f'  shadow: {n_sh} traced rays')
    del shadow, bounce
    c2_spp = int(gold_c2['spp'])
    zero_counts()
    im, tm = R.render(zs, zsm, spp=c2_spp, integrator='mispt',
                      tile_size=1 << 20, return_timing=True)
    n13 = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                TDD.intersect_march)}
    p_s, m_s = psnr_mean(im, gold_c2['img'])
    log(f'  render mispt {gsize}x{gsize} {c2_spp} spp (the golden\'s size, '
        f'samples and seeds): vs JAX golden PSNR {p_s:.2f} dB, mean '
        f'{100 * m_s:.5f}% off, launches {n13}, non-finite lane samples '
        f'{tm["nonfinite"]}')
    check(p_s >= CITY_ZOO_SMALL_PSNR and m_s <= CITY_ZOO_SMALL_MEAN
          and tm['nonfinite'] == 0 and streamed_launched(n13, 2),
          f'zoo city II at the golden\'s size off the golden: {p_s:.2f} dB, '
          f'mean {100 * m_s:.5f}% off, launches {n13}')
    del zs
    zero_counts()
    im, tm = R.render(zc, zcm, spp=CITY2_SPP, integrator='mispt',
                      tile_size=1 << 20, return_timing=True)
    n13 = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                TDD.intersect_march)}
    rate = zcm.width * zcm.height * CITY2_SPP / tm['total_s'] / 1e6
    log(f'  render mispt {CITY2_SPP} spp: {tm["total_s"]:.2f} s, '
        f'{rate:.4f} Msamples/s, launches {n13}, non-finite lane samples '
        f'{tm["nonfinite"]}')
    check(streamed_launched(n13, 2) and tm['nonfinite'] == 0
          and np.isfinite(im).all(), f'zoo city II mispt: launches {n13}, '
          f'{tm["nonfinite"]} non-finite samples')
    del zc

    # ---- 14. the spectral box through K1's spectral variant --------------
    # tests/zoo_scenes.write_spectral_box (k1=True): SPD Lambert and
    # Oren-Nayar diffuses, gold-like rough and smooth conductors, the
    # textured GLTF quad and walls, a blackbody rect light, a flat sky with
    # an SPD, loaded in spectral mode; each integrator through its spectral
    # variant, held against the plain version on every lane of a full
    # frame, timed and counted, rendered with both entry points against the
    # JAX goldens
    t14 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spath = zoo_scenes.write_spectral_box(tmp, 1024, 768, 6)
        sbox, smeta = B.load_scene(spath, spectral_mode=True, device=dev)
        sg, sgm = B.load_scene(spath, spectral_mode=True, device=dev,
                               width=128, height=96)
    spk = MK.pack(sbox, smeta)
    sxy, ssu = MK.lane_setup(smeta, dev)
    sn, sdepth = sxy.shape[1], smeta.trace_depth
    log(f'[14] the spectral box {smeta.width}x{smeta.height}: '
        f'{smeta.num_tris} triangles, material types '
        f'{smeta.mat_types_present}, {sbox.spec_offset_sz.shape[0]} spectra, '
        f'lights {smeta.light_geom_types}, depth {sdepth}, {sn} lanes; K1 '
        f'gate: {MK.why_unsupported(sbox, smeta)}')
    check(R.use_megakernel(sbox, smeta) and spk.spectral,
          'the spectral box is not routed to K1')
    stables = (spk.wide.nodes, spk.wide.rows, spk.wide.index, spk.shade,
               spk.mat, spk.light, spk.tex, spk.consts, spk.texels, spk.spd,
               spk.spd_off, spk.cie)
    spec_rec = {}
    for name in ZOO_INT:
        itype = MK.INTEGRATOR_BY_NAME[name]
        var = MK.variant_of(spk, itype)
        attrs = MK.kernel_attrs(MK.kernel_library(var), spk)
        rec = dict(variant=list(var), registers={
            k: (a['registers'], a['local_bytes']) for k, a in attrs.items()})
        log(f'  {name}, K1 at this pack: {layout_line(attrs)}')
        k_f = MK.sample_pass(spk, sxy, ssu, sdepth, itype)
        p_f, p_ms = timed(lambda: MK.sample_pass_plain(spk, sxy, ssu, sdepth,
                                                       itype))
        c, e, err_f = MK.lanes_agree(k_f, p_f, 3)
        nonfin = int((~torch.isfinite(k_f[0])).any(0).sum())
        log(f'  {name}, K1 spectral variant {var}, registers / local bytes '
            f'{rec["registers"]}: fixed chain, {sn} lanes close {c:.6f}, '
            f'RNG/flags equal {e:.6f}, max|d| {err_f:.3e}, non-finite lane '
            f'samples {nonfin}')
        check(c == 1.0 and e == 1.0 and nonfin == 0,
              f'spectral {name} fixed chain: {c} / {e} of lanes agree, '
              f'{nonfin} non-finite')
        del k_f, p_f
        sf, sr = MK.regen_pass(spk, sxy, None, ssu, it, sdepth, first=True,
                               integrator=itype)
        k_r = MK.regen_pass(spk, sxy, sf, sr, it, sdepth, integrator=itype)
        sfp, srp = MK.regen_iters_plain(spk, sxy, None, ssu, it, sdepth,
                                        first=True, integrator=itype)
        p_r, p_ms_r = timed(lambda: MK.regen_iters_plain(
            spk, sxy, sfp, srp, it, sdepth, integrator=itype))
        c, e, err_r = MK.lanes_agree(k_r, p_r, MK.RU_NROWS)
        log(f'  {name}: regen ({it} iterations after rfirst + {it - 1}, '
            f'{sf.shape[0]} f32 state rows), close {c:.6f}, RNG/flags/counts '
            f'equal {e:.6f}, max|d| {err_r:.3e}')
        check(c == 1.0 and e == 1.0,
              f'spectral {name} regen: {c} / {e} of lanes agree')
        del k_r, p_r, sfp, srp
        rec['max_abs_err'] = dict(mega_sample=err_f, mega_regen=err_r)
        # lane state in and out: the fixed chain's xy, seeds, contribution
        # and u32 rows; regen's 34 f32 and 5 u32 rows both ways and xy
        for kname, run, io, pms in (
                ('mega_sample', lambda: MK.sample_pass(spk, sxy, ssu, sdepth,
                                                       itype), 64 * sn, p_ms),
                ('mega_regen', lambda: MK.regen_pass(
                    spk, sxy, sf, sr, it, sdepth, integrator=itype),
                 (2 * (4 * MK.rf_nrows(True) + 8 * MK.RU_NROWS) + 8) * sn,
                 p_ms_r)):
            k_ms = cuda_ms(run, 10)
            cnt = k1_counted(run, var)
            ops = (cnt[0] * WOOP_OPS + cnt[1] * SLAB_OPS
                   + shade_ops(cnt, naive=itype == MK.INTEGRATOR_STUPID_PT,
                               spectral=True) + SPEC_SAMPLE_OPS * sn)
            b = bound(io + nbytes(*stables), ops)
            per = ', '.join(f'{k} {x / sn:.3f}' for k, x in
                            zip(SHADE_KINDS, cnt[2:]))
            log(f'  {name} {kname} (spectral): {k_ms:.3f} ms per '
                f'{"pass" if kname == "mega_sample" else "launch"}; plain '
                f'{pms:.3f} ms; per lane {cnt[0] / sn:.3f} Woop, '
                f'{cnt[1] / sn:.3f} child-box tests, shades {per}; bound '
                f'{b[0]:.4f} ms by {b[1]} ({k_ms / b[0]:.1f}x above)')
            rec[kname] = dict(ms=k_ms, plain_ms=pms, bound_ms=b[0],
                              bound_by=b[1], operations=ops)
        gold_s = np.load(zoo_scenes.golden_path(
            f'spec_box_{name}_128.npz'))['img']
        imgs = {}
        for kname, regen in (('mega_sample', False), ('mega_regen', True)):
            zero_counts()
            img, tm = R.render(sbox, smeta, spp=BOX_SPP, integrator=name,
                               regen=regen, return_timing=True)
            n_l = (MK.regen_pass if regen else MK.sample_pass).launches
            others = {w_.__name__: w_.launches for w_ in counters
                      if w_ not in (MK.sample_pass, MK.regen_pass)}
            samples = tm.get('samples', smeta.width * smeta.height * BOX_SPP)
            p, m_ = psnr_mean(img, gold_s)
            rate = samples / tm['total_s'] / 1e6
            log(f'  {name} render {"regen" if regen else "fixed"} {BOX_SPP} '
                f'spp: {tm["total_s"]:.3f} s, {rate:.2f} Msamples/s, '
                f'launches {n_l} (other kernels {others}), non-finite lane '
                f'samples {tm["nonfinite"]}; vs JAX golden PSNR {p:.2f} dB, '
                f'mean {100 * m_:.3f}% off')
            check(n_l > 0 and not any(others.values()),
                  f'spectral {name} {kname}: K1 launches {n_l}, others '
                  f'{others}')
            check(tm['nonfinite'] == 0 and np.isfinite(img).all(),
                  f'spectral {name} {kname}: non-finite samples')
            check(p >= SPEC_PSNR.get(name, 0.0) and m_ <= SPEC_MEAN[name],
                  f'spectral {name} {kname} off the golden: {p:.2f} dB, '
                  f'mean {100 * m_:.3f}% off')
            rec[kname].update(launches=n_l, msamples_s=rate, psnr=p,
                              mean_off=m_)
            imgs[kname] = img[..., :3]
        small = imgs['mega_sample'].reshape(96, 8, 128, 8, 3).mean((1, 3))
        p_rf, _ = psnr_mean(imgs['mega_regen'], small)
        log(f'  {name}: regen vs fixed chain PSNR {p_rf:.2f} dB (8x box '
            'means)')
        check(p_rf >= REGEN_PSNR_MIN, f'spectral {name}: regen vs fixed '
              f'{p_rf:.2f} dB')
        rec['regen_vs_fixed_db'] = p_rf
        # the golden's size, samples and seeds: the golden's own streams
        gspp = int(np.load(zoo_scenes.golden_path(
            f'spec_box_{name}_128.npz'))['spp'])
        zero_counts()
        ig, tg = R.render(sg, sgm, spp=gspp, integrator=name,
                          return_timing=True)
        pg, mg = psnr_mean(ig, gold_s)
        log(f'  {name} render fixed {sgm.width}x{sgm.height} {gspp} spp (the '
            f'golden\'s size, samples and seeds): PSNR {pg:.2f} dB, mean '
            f'{100 * mg:.5f}% off, K1 launches {MK.sample_pass.launches}, '
            f'non-finite lane samples {tg["nonfinite"]}')
        check(pg >= SPEC_SEED_PSNR and tg['nonfinite'] == 0
              and MK.sample_pass.launches > 0, f'spectral {name} at the '
              f'golden\'s size and seeds: {pg:.2f} dB')
        rec['golden_seed_db'] = pg
        spec_rec[name] = rec
    del sbox, sg, spk
    log(f'  phase 14: {time.perf_counter() - t14:.1f} s')

    # ---- 15. the spectral box II on the batched route (K5) -----------------
    # write_spectral_box(k1=False): the spectral box plus a dielectric with a
    # Cauchy IOR SPD (its waves diverge), an old-Hydra glass, a
    # spectral-texture diffuse, a thin film with an SPD layer eta and a
    # thickness-mapped one (the Airy sum at trace time), a blend, a float
    # sky with an SPD and XYZ camera-response spectra: K1 refuses it, so
    # the batched integrator renders it through K5
    t15 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spath = zoo_scenes.write_spectral_box(tmp, 1024, 768, 6, k1=False)
        s2, s2m = B.load_scene(spath, spectral_mode=True, device=dev)
        gold15 = np.load(zoo_scenes.golden_path('spec_box2_mispt_128.npz'))
        gold16 = np.load(zoo_scenes.golden_path('spec_box2_16ch_early.npz'))
        gh, gw = gold15['early'].shape[:2]
        s2g, s2gm = B.load_scene(spath, spectral_mode=True, device=dev,
                                 width=gw, height=gh)
    log(f'[15] the spectral box II {s2m.width}x{s2m.height}: material types '
        f'{s2m.mat_types_present}, spectral textures {s2m.has_spd_tex}, '
        f'response spectra {s2m.has_cam_response_spectra}, env sampled '
        f'{s2m.env_enable_sam}; K1 gate: {MK.why_unsupported(s2, s2m)}')
    check(not R.use_megakernel(s2, s2m) and not (
        s2m.use_stream or s2m.use_pallas or s2m.use_stream_tlas),
        'the spectral box II is routed to K1, or is not small')
    zero_counts()
    im, tm = R.render(s2, s2m, spp=ZOO_TWIN_SPP, integrator='mispt',
                      tile_size=1 << 20, return_timing=True)
    n15 = {w_.__name__: w_.launches for w_ in counters}
    rate15 = s2m.width * s2m.height * ZOO_TWIN_SPP / tm['total_s'] / 1e6
    p, m_ = psnr_mean(im, gold15['img'])
    log(f'  render mispt {ZOO_TWIN_SPP} spp: {tm["total_s"]:.2f} s, '
        f'{rate15:.4f} Msamples/s, launches {n15}, non-finite lane samples '
        f'{tm["nonfinite"]}; vs the {int(gold15["spp"])}-sample golden PSNR '
        f'{p:.2f} dB, mean {100 * m_:.3f}% off')
    check(n15['intersect_clusters'] > 0 and n15['sample_pass'] == 0
          and n15['regen_pass'] == 0 and tm['nonfinite'] == 0
          and np.isfinite(im).all(), f'spectral box II: launches {n15}, '
          f'{tm["nonfinite"]} non-finite samples')
    del s2, im
    early = int(gold15['early_spp'])
    rec15 = dict(msamples_s=rate15, k5_launches=n15['intersect_clusters'])
    for label, ch, gold in (('RGB', 4, gold15['early']),
                            (f'{SPEC_CHANNELS}-channel', SPEC_CHANNELS,
                             gold16['img'])):
        zero_counts()
        ig, tg = R.render(s2g, s2gm, spp=early, integrator='mispt',
                          channels=ch, return_timing=True)
        ig = ig if ch > 4 else ig[..., :3]
        mse = float(np.mean((ig - gold) ** 2))
        pg = 10.0 * np.log10(max(float(gold.max()), 1e-9) ** 2
                             / max(mse, 1e-20))
        log(f'  render mispt {label} {gw}x{gh} {early} spp (the golden\'s '
            f'size, seeds and first samples): {ig.shape}, PSNR {pg:.2f} dB, '
            f'K5 launches {TPL.intersect_clusters.launches}, K1 launches '
            f'{MK.sample_pass.launches + MK.regen_pass.launches}, non-finite '
            f'lane samples {tg["nonfinite"]}')
        check(pg >= CITY_ZOO_SMALL_PSNR and tg['nonfinite'] == 0
              and np.isfinite(ig).all() and ig.shape[-1] == gold.shape[-1],
              f'spectral box II {label} at the golden\'s size off the '
              f'golden: {pg:.2f} dB')
        rec15[f'golden_db_{ch}ch'] = pg
    del s2g
    log(f'  phase 15: {time.perf_counter() - t15:.1f} s')

    # ---- 16. the feature box (K5) and the feature city (K2/K3) -------------
    # spot, IES and projective lights, normal maps, GLTF slot-2/3 maps, the
    # camera-back texture, the thin-lens and lens-stack cameras: what K1
    # refuses, so the batched route renders them
    t16 = time.perf_counter()

    def at(msg):
        log(f'  {msg} ({time.perf_counter() - t16:.1f} s into phase 16)')

    def golden_size(sc, mt, w, h):
        """The scene at the golden's size: its tables are the full frame's
        (the aspect, and so the projection, is the same), its meta says
        the golden's width and height."""
        assert mt.width * h == mt.height * w
        return sc, dataclasses.replace(mt, width=w, height=h)

    rec16 = dict(launches={})
    with tempfile.TemporaryDirectory() as tmp:
        feat = {}
        for cam in zoo_scenes.FEATURE_CAMERAS:
            fpath = zoo_scenes.write_feature_box(os.path.join(tmp, cam), 1024,
                                                 768, 6, camera=cam)
            gold = np.load(zoo_scenes.golden_path(
                f'feat_box_{cam}_mispt_128.npz'))
            gh, gw = gold['early'].shape[:2]
            full = B.load_scene(fpath, device=dev)
            feat[cam] = (full, golden_size(*full, gw, gh), gold)
            if cam == 'pinhole':
                gold_sp = np.load(zoo_scenes.golden_path(
                    'feat_spec_box_mispt_128.npz'))
                feat['spectral'] = (None, B.load_scene(
                    fpath, spectral_mode=True, device=dev, width=gw,
                    height=gh), gold_sp)
            if cam == 'optics':
                opt_s = B.load_scene(fpath, device=dev, accel='stream')
        cpath = zoo_scenes.write_feature_city(os.path.join(tmp, 'city'),
                                              width=1024, height=1024,
                                              depth=5, textured=True)
        fc, fcm = B.load_scene(cpath, device=dev)
        gold_fc = np.load(zoo_scenes.golden_path('feat_city_mispt_128.npz'))
        gsize = gold_fc['img'].shape[0]
        fcs, fcsm = golden_size(fc, fcm, gsize, gsize)
    at('the feature scenes written and loaded')
    (f0, f0m), _, _ = feat['pinhole']
    n16 = f0m.width * f0m.height
    log(f'[16] the feature box {f0m.width}x{f0m.height}: {f0m.num_tris} '
        f'triangles, {f0m.num_lights} lights (distributions '
        f'{f0m.light_dist_types}), IES {f0m.has_ies}, spot {f0m.has_spot}, '
        f'normal maps {f0m.has_bump}, slot-2/3 maps {f0m.has_four_textures}, '
        f'camera-back {f0m.has_cam_back}; K1 gate: '
        f'{MK.why_unsupported(f0, f0m)}')
    small16 = lambda sc, *q, **kw: TPL.intersect_clusters(  # noqa: E731
        None, None, sc.cl_tris12, *q, wide=sc.cl_wide, **kw)

    def k5_lanes(tag, sc, mt, queries):
        """K5 against its plain version on every lane of ``queries``
        ((label, (pos, dir, t_min, t_max), any_hit), ...), each timed,
        counted and bounded."""
        wide16 = tuple(sc.cl_wide.tensors().values())
        for label, q, any_hit in queries:
            p16, p_ms = timed(lambda: TPL.intersect_clusters_plain(
                sc.cl_tris12, *q, any_hit))
            k16 = small16(sc, *q, any_hit=any_hit)
            dt = compare(f'K5 intersect_clusters feature box {tag} {label}',
                         k16, p16, any_hit, exact=True)
            errs['intersect_clusters'] = max(errs['intersect_clusters'], dt)
            if any_hit:
                valid = TPL.occluder_valid(sc.cl_tris12, k16[1], *q)
                check(bool((valid == (k16[1] >= 0)).all()), 'feature box K5 '
                      'any-hit reported a triangle that does not occlude its '
                      'lane')
            k_ms = cuda_ms(lambda: small16(sc, *q, any_hit=any_hit), 10)
            b16 = query_counts('intersect_clusters', f'feature box {tag} '
                               f'{label}', lambda: small16(
                                   sc, *q, any_hit=any_hit), wide16, MT_OPS,
                               n=n16)
            log(f'  {tag} {label}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms')
            rec16[f'{tag} {label}'] = dict(ms=k_ms, plain_ms=p_ms,
                                           bound_ms=b16[0], bound_by=b16[1],
                                           max_abs_err=dt)

    for cam in zoo_scenes.FEATURE_CAMERAS:
        (sc, mt), (scg, mtg), gold = feat[cam]
        check(not any(R.use_megakernel(sc, mt, n) for n in ZOO_INT)
              and not (mt.use_stream or mt.use_pallas or mt.use_stream_tlas),
              f'the feature box ({cam}) is routed to K1, or is not small')
        if cam == 'pinhole':
            cam16, shadow16, bounce16, traced16 = first_bounce_queries(sc, mt)
            log(f'  pinhole: {traced16} traced shadow rays')
            k5_lanes(cam, sc, mt, (('camera nearest', cam16, False),
                                   ('shadow any-hit', shadow16, True),
                                   ('bounce nearest', bounce16, False)))
            del cam16, shadow16, bounce16
            at('pinhole queries checked')
        if cam == 'optics':
            cam16 = first_bounce_queries(sc, mt)[0]
            failed = cam16[0][:, 1] < -1e6
            log(f'  optics: {int(failed.sum())} of {n16} camera rays failed '
                f'the lens stack (started at y = -1e7, looking down)')
            check(int(failed.sum()) > 0, 'no camera ray failed the lens stack')
            k5_lanes(cam, sc, mt, (('camera nearest', cam16, False),))
            # K3 and K2 on the same rays over the box streamed
            (os_, osm) = opt_s
            plain_o = TST.intersect_plain(os_.st_woop, *cam16[:3],
                                          torch.clamp(cam16[3], max=0.99
                                                      * TST.FLT_MAX))
            *km, un = TDD.intersect_march(os_.st_grid, os_.st_woop, *cam16,
                                          with_unresolved=True,
                                          wide=os_.st_wide)
            ks = TST.intersect_stream(os_.st_nodes_f, os_.st_nodes_i,
                                      os_.st_woop, *cam16, wide=os_.st_wide)
            for kname, out in (('K3', km), ('K2', ks)):
                a = hits_agree(out, plain_o, False)
                miss_ok = bool((out[1][failed] < 0).all())
                log(f'  {kname} optics camera (streamed box): lanes with '
                    f'another hit flag {a["hit_diff"]}, another triangle '
                    f'{a["tri_diff"]}, max|dt| {a["max_dt"]:.3e}; failed '
                    f'rays all missed {miss_ok}')
                check(a['hit_diff'] == 0 and a['tri_diff'] == 0 and miss_ok
                      and a['max_duv'] <= UV_TOL, f'feature box optics '
                      f'{kname}: {a["hit_diff"]} / {a["tri_diff"]} lanes '
                      'unlike the plain version')
            check(int(un.sum()) == 0, f'optics camera: {int(un.sum())} '
                  'unresolved march lanes')
            del cam16, plain_o, km, ks, opt_s
            at('optics queries checked')
        zero_counts()
        spp16 = FEAT_SPP if cam == 'pinhole' else RATE_SPP
        im, tm = R.render(sc, mt, spp=spp16, integrator='mispt',
                          tile_size=1 << 20, return_timing=True)
        n_l = {w_.__name__: w_.launches for w_ in counters}
        rate = n16 * spp16 / tm['total_s'] / 1e6
        p, m_ = psnr_mean(im, gold['img'])
        log(f'  render {cam} mispt {spp16} spp: {tm["total_s"]:.2f} s, '
            f'{rate:.4f} Msamples/s, launches {n_l}, non-finite lane samples '
            f'{tm["nonfinite"]}; vs the {int(gold["spp"])}-sample golden '
            f'PSNR {p:.2f} dB, mean {100 * m_:.3f}% off')
        check(n_l['intersect_clusters'] > 0 and n_l['sample_pass'] == 0
              and n_l['regen_pass'] == 0 and tm['nonfinite'] == 0
              and np.isfinite(im).all(), f'feature box {cam}: launches '
              f'{n_l}, {tm["nonfinite"]} non-finite samples')
        if cam == 'pinhole':
            check(p >= PSNR_MIN and m_ <= MEAN_TOL, f'feature box pinhole off '
                  f'the golden: {p:.2f} dB, mean {100 * m_:.3f}% off')
        rec16['launches'][cam] = n_l['intersect_clusters']
        rec16[cam] = dict(msamples_s=rate, nonfinite=tm['nonfinite'],
                          golden_db=p, golden_mean_off=m_)
        del im, sc
        at(f'{cam} rendered')
    for cam in zoo_scenes.FEATURE_CAMERAS + ('spectral',):
        _, (scg, mtg), gold = feat[cam]
        early = int(gold['early_spp'])
        zero_counts()
        ig, tg = R.render(scg, mtg, spp=early, integrator='mispt',
                          return_timing=True)
        pg, mg = psnr_mean(ig, gold['early'])
        log(f'  render {cam} {mtg.width}x{mtg.height} {early} spp (the '
            f'golden\'s size, seeds and first samples): PSNR {pg:.2f} dB, '
            f'mean {100 * mg:.5f}% off, K5 launches '
            f'{TPL.intersect_clusters.launches}, K1 launches '
            f'{MK.sample_pass.launches + MK.regen_pass.launches}, non-finite '
            f'lane samples {tg["nonfinite"]}')
        check(pg >= CITY_ZOO_SMALL_PSNR and tg['nonfinite'] == 0
              and MK.sample_pass.launches + MK.regen_pass.launches == 0,
              f'feature box {cam} at the golden\'s size off the golden: '
              f'{pg:.2f} dB')
        rec16.setdefault(cam, {})['seeds_db'] = pg
    # the eager ops of one pass at the golden's size (the pinhole box)
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            OpCount.n += 1
            return func(*args, **(kwargs or {}))

    _, (scg, mtg), _ = feat['pinhole']
    pix = torch.arange(mtg.width * mtg.height, device=dev)
    with OpCount():
        IPT.trace_pass(scg, mtg, RNG.gen_init(pix), pix)
    rec16['eager_ops_per_pass'] = OpCount.n
    log(f'  one mispt pass of the feature box: {OpCount.n} eager ops')
    at('the goldens\' sizes rendered')
    del feat, scg, pix
    # the feature city through K2/K3
    log(f'  the feature city {fcm.width}x{fcm.height}: IES {fcm.has_ies}, '
        f'spot {fcm.has_spot}, normal maps {fcm.has_bump}, use_stream '
        f'{fcm.use_stream}')
    cam_c, _, bounce_c, n_shc = first_bounce_queries(fc, fcm)
    fstream = lambda *q, **kw: TST.intersect_stream(  # noqa: E731
        fc.st_nodes_f, fc.st_nodes_i, fc.st_woop, *q, wide=fc.st_wide, **kw)
    fmarch = lambda *q: TDD.intersect_march(  # noqa: E731
        fc.st_grid, fc.st_woop, *q, with_unresolved=True, wide=fc.st_wide)
    # the city's triangles and camera are the bench city's: where its
    # camera query is phase 3's bit for bit, phase 3's dense plain answer
    # is this query's (the dense plain version takes ~50 s a query here;
    # the shadow any-hit is held on the other cities' queries)
    same_cam = torch.equal(fc.st_woop, woop) and all(
        torch.equal(a, b) for a, b in zip(cam_c, cam_q))
    log(f'  the feature city\'s triangles and camera query equal phase 3\'s: '
        f'{same_cam}')
    for label, q, any_hit in (('camera', cam_c, False),
                              ('first bounce', bounce_c, False)):
        plain_q = (cam_plain if label == 'camera' and same_cam else
                   TST.intersect_plain(fc.st_woop, *q[:3], torch.clamp(
                       q[3], max=0.99 * TST.FLT_MAX), any_hit=any_hit))
        outs = [('K2', fstream(*q, any_hit=any_hit))]
        if not any_hit:
            *km, un = fmarch(*q)
            outs.append(('K3', km))
            check(int(un.sum()) == 0, f'feature city {label}: '
                  f'{int(un.sum())} unresolved march lanes')
        for kname, out in outs:
            a = hits_agree(out, plain_q, any_hit)
            log(f'  {kname} {label}: lanes with another hit flag '
                f'{a["hit_diff"]}, another triangle {a["tri_diff"]} '
                f'({a["tie_diff"]} at equal t), max|dt| {a["max_dt"]:.3e}, '
                f'max|du|,|dv| {a["max_duv"]:.3e}')
            check(a['hit_diff'] == 0 and a['tri_diff'] == 0
                  and a['max_duv'] <= UV_TOL,
                  f'feature city {kname} {label}: {a["hit_diff"]} / '
                  f'{a["tri_diff"]} lanes unlike the plain version')
    log(f'  shadow: {n_shc} traced rays')
    del cam_c, bounce_c, plain_q, outs
    at('the feature city\'s queries checked')
    zero_counts()
    im, tm = R.render(fc, fcm, spp=FEAT_SPP, integrator='mispt',
                      tile_size=1 << 20, return_timing=True)
    n_c = {w_.__name__: w_.launches for w_ in counters}
    rate = fcm.width * fcm.height * FEAT_SPP / tm['total_s'] / 1e6
    log(f'  render feature city mispt {FEAT_SPP} spp: {tm["total_s"]:.2f} s, '
        f'{rate:.4f} Msamples/s, launches {n_c}, non-finite lane samples '
        f'{tm["nonfinite"]}')
    check(streamed_launched(n_c, 2) and tm['nonfinite'] == 0
          and np.isfinite(im).all() and n_c['sample_pass'] == 0,
          f'feature city mispt: launches {n_c}, {tm["nonfinite"]} non-finite '
          'samples')
    rec16['city'] = dict(msamples_s=rate, nonfinite=tm['nonfinite'],
                         launches={k: n_c[k] for k in ('intersect_stream',
                                                       'intersect_march')})
    del fc, im
    c_spp = int(gold_fc['spp'])
    zero_counts()
    im, tm = R.render(fcs, fcsm, spp=c_spp, integrator='mispt',
                      tile_size=1 << 20, return_timing=True)
    n_c = {w_.__name__: w_.launches for w_ in (TST.intersect_stream,
                                                TDD.intersect_march)}
    p_c, m_c = psnr_mean(im, gold_fc['img'])
    log(f'  render feature city mispt {gsize}x{gsize} {c_spp} spp (the '
        f'golden\'s size, samples and seeds): PSNR {p_c:.2f} dB, mean '
        f'{100 * m_c:.5f}% off, launches {n_c}, non-finite lane samples '
        f'{tm["nonfinite"]}')
    check(p_c >= CITY_ZOO_SMALL_PSNR and m_c <= CITY_ZOO_SMALL_MEAN
          and tm['nonfinite'] == 0 and streamed_launched(n_c, 2),
          f'feature city at the golden\'s size off the golden: {p_c:.2f} dB, '
          f'mean {100 * m_c:.5f}% off, launches {n_c}')
    rec16['city']['seeds_db'] = p_c
    del fcs
    launches['intersect_clusters'] += rec16['launches']['pinhole']
    for k in ('intersect_stream', 'intersect_march'):
        launches[k] += rec16['city']['launches'][k]
    log(f'  phase 16: {time.perf_counter() - t16:.1f} s')

    # ---- 17. motion blur (K4's motion variant), Whitted, the G-buffer and
    # the direct / indirect layers -------------------------------------------
    t17 = time.perf_counter()

    def at17(msg):
        log(f'  {msg} ({time.perf_counter() - t17:.1f} s into phase 17)')

    from hydracore3_torch.models import gbuffer as GB
    from hydracore3_torch.models import integrator_rt as RT
    km_names = ('intersect_tlas_motion_kernel<nearest>',
                'intersect_tlas_motion_kernel<any-hit>')
    attrs17 = TST.kernel_attrs()
    log('[17] K4 motion variant: ' + ', '.join(
        f'{k} {attrs17[k][0]} registers {attrs17[k][1]} local bytes'
        for k in km_names) + '; of its counting build ' + ', '.join(
        f'{k} {v}' for k, v in TST.kernel_attrs(count_lib).items()
        if k in km_names))
    rec17 = dict(registers={k: attrs17[k] for k in km_names})
    # the motion libraries, which phase 21 loads again under accel='bvh'
    lib17 = tempfile.TemporaryDirectory()
    mb_path = zoo_scenes.write_motion_box(os.path.join(lib17.name, 'mb'),
                                          **MOTION_BOX)
    mc_path = zoo_scenes.write_motion_city(os.path.join(lib17.name, 'mc'),
                                           **MOTION_CITY)
    with tempfile.TemporaryDirectory() as tmp:
        rt_path = zoo_scenes.write_rt_box(os.path.join(tmp, 'rt'), 1024,
                                          768, 6)
        t0 = time.perf_counter()
        mbox = B.load_scene(mb_path, device=dev)
        mbox_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mcity = B.load_scene(mc_path, device=dev)
        torch.cuda.synchronize()
        mcity_s = time.perf_counter() - t0
        rtbox = B.load_scene(rt_path, device=dev)
    gold_mb = np.load(zoo_scenes.golden_path('motion_box_mispt_128.npz'))
    gold_mc = np.load(zoo_scenes.golden_path('motion_city_mispt_128.npz'))
    gold_rb = np.load(zoo_scenes.golden_path('rt_box_256.npz'))
    gold_rc = np.load(zoo_scenes.golden_path('rt_city_128.npz'))
    for label, (sc, mt) in (('motion box', mbox), ('motion city', mcity)):
        tl = sc.two_level
        moving = int(tl.inst_has_motion.sum())
        log(f'  {label} {mt.width}x{mt.height}: {mt.num_tris} triangles at '
            f'the shutter\'s open, {tl.inst_m0.shape[0]} instances '
            f'({moving} moving) of {tl.blas_node_base.shape[0]} meshes; '
            f'use_two_level {mt.use_two_level}, use_stream_tlas '
            f'{mt.use_stream_tlas}; the kernel\'s tables: '
            f'{tl.wide.nodes.shape[0]} wide nodes, {tl.wide.rows.shape[0]} '
            f'rows, stack {tl.wide.stack}, margin {tl.wide.margin:.3e}, '
            f'{nbytes(*tl.wide.tensors().values()) / 2**20:.2f} MiB; K1 '
            f'gate: {MK.why_unsupported(sc, mt)}')
        check(mt.use_two_level and mt.has_motion and not mt.use_stream_tlas
              and moving > 0 and not R.use_megakernel(sc, mt),
              f'{label}: not routed two-level by time under accel=auto')
    log(f'  loaded in {mbox_s:.2f} s (box) and {mcity_s:.2f} s (city)')
    at17('the motion scenes loaded')

    def motion_lanes(label, sc, mt, lanes=None):
        """K4's motion variant against its plain version on the pass's
        camera, shadow and first-bounce queries at the lanes' times (the
        first ``lanes`` lanes only, if given), each timed, counted and
        bounded at full width."""
        tl = sc.two_level
        n = mt.width * mt.height
        pix = torch.arange(n, device=dev)
        tm_ = IPT.kernel_init_eye_ray(sc, mt, RNG.gen_init(pix), pix).time
        cam_, shadow_, bounce_, traced_ = first_bounce_queries(sc, mt)
        tabs = tuple(tl.wide.tensors().values()) + (tm_,)
        out = {}
        for qlabel, q, any_hit in (('camera nearest', cam_, False),
                                   ('shadow any-hit', shadow_, True),
                                   ('bounce nearest', bounce_, False)):
            run = lambda: TL2.intersect_two_level(  # noqa: E731
                tl, *q, tm_, any_hit)
            k = run()
            sub = slice(None) if lanes is None else slice(0, lanes)
            qs = tuple(x[sub] for x in q)
            p, p_ms = timed(lambda: TL2.intersect_two_level_plain(
                tl, *qs, tm_[sub], any_hit))
            ks = tuple(x[sub] for x in k)
            flags_eq = bool(torch.equal(ks[1] >= 0, p[1] >= 0))
            if any_hit:
                valid = TL2.occluder_valid(tl, ks[1], ks[2], *qs, tm_[sub])
                ok = flags_eq and bool(torch.equal(valid, ks[1] >= 0))
                err = 0.0
                detail = 'reported pairs occlude their lanes'
            else:
                same = (ks[1] == p[1]) & (ks[2] == p[2])
                ok = flags_eq and bool(same.all()) and all(
                    bool(torch.equal(a, b)) for a, b in zip(ks, p))
                both_ = (ks[1] >= 0) & (p[1] >= 0)
                err = float((ks[0] - p[0])[both_].abs().max()) \
                    if bool(both_.any()) else 0.0
                detail = (f'{int((~same).sum())} lanes with another '
                          'triangle or instance')
            k_ms = cuda_ms(run, 10)
            b = query_counts('intersect_tlas_motion', f'{label} {qlabel}',
                             run, tabs, MT_OPS, n=n,
                             inst_ops=MOTION_XFORM_OPS)
            log(f'  K4m {label} {qlabel}: hits {int((k[1] >= 0).sum())}/{n}; '
                f'{ks[1].numel()} lanes against the plain version: hit flags '
                f'equal {flags_eq}, {detail}; kernel {k_ms:.3f} ms at full '
                f'width, plain {p_ms:.3f} ms on {ks[1].numel()} lanes')
            check(ok, f'K4m {label} {qlabel}: lanes unlike the plain version')
            out[qlabel] = dict(ms=k_ms, plain_ms=p_ms, plain_lanes=int(
                ks[1].numel()), bound_ms=b[0], bound_by=b[1],
                counts=b[2], max_abs_err=err)
        log(f'  {label} shadow: {traced_} traced rays')
        return out

    rec17['motion_box'] = motion_lanes('motion box', *mbox)
    at17('the motion box\'s queries checked')
    rec17['motion_city'] = motion_lanes('motion city', *mcity, TESS_LANES)
    at17('the motion city\'s queries checked')
    for label, (sc, mt), gold in (('motion box', mbox, gold_mb),
                                  ('motion city', mcity, gold_mc)):
        key = label.replace(' ', '_')
        zero_counts()
        im, tm = R.render(sc, mt, spp=MOTION_SPP, integrator='mispt',
                          tile_size=1 << 20, return_timing=True)
        n_l = {w_.__name__: w_.launches for w_ in counters}
        rate = mt.width * mt.height * MOTION_SPP / tm['total_s'] / 1e6
        log(f'  render {label} mispt {MOTION_SPP} spp: {tm["total_s"]:.2f} s, '
            f'{rate:.4f} Msamples/s, launches {n_l}, non-finite lane samples '
            f'{tm["nonfinite"]}')
        check(n_l['intersect_two_level'] > 0 and n_l['sample_pass'] == 0
              and n_l['regen_pass'] == 0 and tm['nonfinite'] == 0
              and np.isfinite(im).all(), f'{label}: launches {n_l}, '
              f'{tm["nonfinite"]} non-finite samples')
        rec17[key].update(launches=n_l['intersect_two_level'],
                          msamples_s=rate, nonfinite=tm['nonfinite'])
        gh, gw = gold['early'].shape[:2]
        scg, mtg = golden_size(sc, mt, gw, gh)
        early = int(gold['early_spp'])
        zero_counts()
        ig, tg = R.render(scg, mtg, spp=early, integrator='mispt',
                          return_timing=True)
        pg, mg = psnr_mean(ig, gold['early'])
        near = float((np.abs(ig[..., :3] - gold['early']).max(-1)
                      <= 1e-3).mean())
        log(f'  render {label} {gw}x{gh} {early} spp (the golden\'s size, '
            f'seeds and first samples): PSNR {pg:.2f} dB, mean '
            f'{100 * mg:.5f}% off, {near:.6f} of the pixels within 1e-3, '
            f'K4m launches {TL2.intersect_two_level.launches}, non-finite '
            f'lane samples {tg["nonfinite"]}')
        check(pg >= MOTION_SEED_PSNR and near >= MOTION_SEED_PIXELS
              and tg['nonfinite'] == 0
              and TL2.intersect_two_level.launches > 0,
              f'{label} at the golden\'s size off the golden: {pg:.2f} dB, '
              f'{near:.6f} of the pixels within 1e-3')
        rec17[key].update(seeds_db=pg, seeds_pixels_near=near)
        del im, ig
        at17(f'{label} rendered')
    del mcity, mbox

    def rt_all(sc, mt, tile=None):
        """cast_single_ray, ray_trace and eval_gbuffer of every pixel, each
        with its wall seconds and the ray-query launches it made."""
        pix = torch.arange(mt.width * mt.height, device=dev)
        out = {}
        for name, fn in (('cast', RT.cast_single_ray),
                         ('whitted', RT.ray_trace),
                         ('gbuffer', GB.eval_gbuffer)):
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(sc, mt, pix)
            torch.cuda.synchronize()
            out[name] = (res, time.perf_counter() - t0, {
                w_.__name__: w_.launches for w_ in counters
                if w_.launches})
        return out

    def rt_vs_golden(label, res, gold, w, h):
        """The passes at the golden's size against the JAX goldens: colours
        within RT_COLOR_TOL on RT_PIXELS_MIN of the pixels, the G-buffer's
        ids equal on RT_IDS_MIN and its fields within 1e-3 there."""
        shape = (h, w)
        ok = True
        for name in ('cast', 'whitted'):
            a = res[name][0].cpu().numpy().reshape(shape + (4,))
            close = float(np.isclose(a, gold[name], rtol=RT_COLOR_TOL,
                                     atol=RT_COLOR_TOL).all(-1).mean())
            log(f'  {label} {name} {w}x{h} against the golden: {close:.6f} '
                f'of the pixels within {RT_COLOR_TOL}, max |d| '
                f'{float(np.abs(a - gold[name]).max()):.3e}')
            ok &= close >= RT_PIXELS_MIN
        gb = {f: getattr(res['gbuffer'][0], f).cpu().numpy().reshape(
            shape + gold['gb_' + f].shape[2:]) for f in GB.GBuffer._fields}
        same = np.ones(shape, bool)
        for f in ('obj_id', 'inst_id', 'mat_id'):
            same &= gb[f] == gold['gb_' + f]
        fields = same & np.isclose(gb['depth'], gold['gb_depth'], rtol=1e-3,
                                   atol=0)
        for f in ('norm', 'texc', 'rgba'):
            fields &= np.isclose(gb[f], gold['gb_' + f], rtol=1e-3,
                                 atol=1e-3).all(-1)
        log(f'  {label} G-buffer {w}x{h} against the golden: ids equal on '
            f'{same.mean():.6f}, every field on {fields.mean():.6f} of the '
            f'pixels')
        ok &= same.mean() >= RT_IDS_MIN and fields.mean() >= RT_IDS_MIN
        check(ok, f'{label}: Whitted / G-buffer off the golden')
        return dict(ids_equal=float(same.mean()),
                    fields_equal=float(fields.mean()))

    city_rt, crt_meta = synth.city_scene(width=1024, height=1024, depth=5,
                                         textured=True, device=dev)
    for label, (sc, mt), gold in (('box', rtbox, gold_rb),
                                  ('bench city', (city_rt, crt_meta),
                                   gold_rc)):
        full = rt_all(sc, mt)
        for name, (res, secs, n_l) in full.items():
            rgb = (res.depth if name == 'gbuffer' else res[:, :3])
            log(f'  {label} {name} {mt.width}x{mt.height}: {secs:.3f} s, '
                f'launches {n_l}, finite {bool(torch.isfinite(rgb).all())}')
            check(bool(torch.isfinite(rgb).all()) and sum(n_l.values()) > 0
                  and 'intersect_two_level' not in n_l,
                  f'{label} {name}: launches {n_l}')
        rec17[f'rt_{label}'] = {n: dict(seconds=v[1], launches=v[2])
                                for n, v in full.items()}
        del full
        h, w = gold['whitted'].shape[:2]
        scg, mtg = golden_size(sc, mt, w, h)
        rec17[f'rt_{label}']['golden'] = rt_vs_golden(
            label, rt_all(scg, mtg), gold, w, h)
        at17(f'Whitted and the G-buffer of the {label} checked')
    del city_rt
    rec17['layers'] = {}
    for layer in ('direct', 'indirect'):
        sc, mt = rtbox
        zero_counts()
        im, tm = R.render(sc, mt, spp=RATE_SPP, integrator='mispt',
                          layer=layer, tile_size=1 << 20, return_timing=True)
        n_l = {w_.__name__: w_.launches for w_ in counters}
        log(f'  render box {layer} layer mispt {RATE_SPP} spp: '
            f'{tm["total_s"]:.2f} s, mean {float(im[..., :3].mean()):.6f}, '
            f'launches {n_l}, non-finite lane samples {tm["nonfinite"]}')
        check(n_l['intersect_clusters'] > 0 and n_l['sample_pass'] == 0
              and n_l['regen_pass'] == 0 and tm['nonfinite'] == 0
              and np.isfinite(im).all(), f'box {layer} layer: launches '
              f'{n_l}')
        rec17['layers'][layer] = dict(seconds=tm['total_s'],
                                      mean=float(im[..., :3].mean()),
                                      launches=n_l['intersect_clusters'])
    del rtbox
    mb = rec17['motion_box']['camera nearest']
    ms['intersect_tlas_motion'] = mb['ms']
    plain_ms['intersect_tlas_motion'] = mb['plain_ms']
    bounds['intersect_tlas_motion'] = (mb['bound_ms'], mb['bound_by'])
    errs['intersect_tlas_motion'] = max(
        v['max_abs_err'] for r in ('motion_box', 'motion_city')
        for k, v in rec17[r].items() if isinstance(v, dict) and 'ms' in v)
    launches['intersect_tlas_motion'] = rec17['motion_box']['launches']
    log(f'  phase 17: {time.perf_counter() - t17:.1f} s')

    # ---- 18. QMC, Kelemen MLT, checkpoint / resume, the command line ------
    t18 = time.perf_counter()

    def at18(msg):
        log(f'  {msg} ({time.perf_counter() - t18:.1f} s into phase 18)')

    from hydracore3_torch import cli as CLI
    from hydracore3_torch.models import kmlt as KM
    from hydracore3_torch.utils import imageio as IIO
    # the kernels each scene's batched route may launch, and must
    route18 = {'box': {'intersect_clusters'},
               'bench city': {'intersect_march', 'intersect_stream'}}

    def launched18(label):
        """This run's launches, and whether they are the route's only."""
        n_l = {w_.__name__: w_.launches for w_ in counters if w_.launches}
        return n_l, set(n_l) == route18[label]

    box18 = synth.box_scene(1024, 768, depth=6, textured=True, device=dev)
    box_mean = float(box_imgs['mega_sample'].mean())
    log(f'[18] QMC, Kelemen MLT, checkpoint / resume and the command line '
        f'on the batched route; phase 5\'s mispt box (K1, {BOX_SPP} spp) '
        f'mean {box_mean:.6f}')
    rec18 = dict(qmc={})
    # (phase 4's golden again: later phases reuse the name ``gold``)
    gold_city = np.load(zoo_scenes.golden_path('city_bench_128.npz'))[
        'img'].astype(np.float32)
    for label, (sc, mt), gold_ds, gold_name in (
            ('box', box18, gold_box, 'qmc_box_mispt_128.npz'),
            ('bench city', (scene, meta), gold_city,
             'qmc_city_mispt_128.npz')):
        zero_counts()
        im, tm = R.render_qmc(sc, mt, spp=QMC_SPP, tile_size=1 << 20,
                              return_timing=True)
        n_l, ok = launched18(label)
        msps = mt.width * mt.height * QMC_SPP / tm['total_s'] / 1e6
        p, m_ = psnr_mean(im, gold_ds)
        log(f'  render_qmc {label} {mt.width}x{mt.height} mispt {QMC_SPP} '
            f'spp: {tm["total_s"]:.2f} s, {msps:.4f} Msamples/s, launches '
            f'{n_l}, non-finite lane samples {tm["nonfinite"]}; vs golden '
            f'PSNR {p:.2f} dB, mean {100 * m_:.3f}% off')
        check(ok and tm['nonfinite'] == 0 and np.isfinite(im).all()
              and p >= PSNR_MIN and m_ <= MEAN_TOL,
              f'render_qmc {label}: launches {n_l}, {p:.2f} dB, mean '
              f'{100 * m_:.3f}% off')
        gq = np.load(zoo_scenes.golden_path(gold_name))['img']
        scg, mtg = golden_size(sc, mt, gq.shape[1], gq.shape[0])
        zero_counts()
        ig, tg = R.render_qmc(scg, mtg, spp=QMC_SPP, return_timing=True)
        n_g, ok_g = launched18(label)
        pg, mg = psnr_mean(ig, gq)
        near = float((np.abs(ig[..., :3] - gq).max(-1) <= 1e-3).mean())
        log(f'  render_qmc {label} {mtg.width}x{mtg.height} {QMC_SPP} spp '
            f'(the QMC golden\'s size, indices and seeds): '
            f'{tg["total_s"]:.2f} s, PSNR {pg:.2f} dB, mean {100 * mg:.5f}% '
            f'off, {near:.6f} of the pixels within 1e-3, launches {n_g}')
        check(ok_g and tg['nonfinite'] == 0 and pg >= MOTION_SEED_PSNR
              and near >= MOTION_SEED_PIXELS,
              f'render_qmc {label} at the golden\'s size: {pg:.2f} dB, '
              f'{near:.6f} of the pixels within 1e-3, launches {n_g}')
        rec18['qmc'][label] = dict(
            seconds=tm['total_s'], msamples_s=msps, launches=n_l,
            golden_db=p, golden_mean_off=m_, seeds_db=pg,
            seeds_pixels_near=near, seeds_seconds=tg['total_s'])
        del im, ig
        at18(f'QMC {label} checked')

    bsc, bmt = box18
    gm = np.load(zoo_scenes.golden_path('mlt_box_128.npz'))
    zero_counts()
    t0 = time.perf_counter()
    im, st = KM.render_mlt(bsc, bmt, spp=QMC_SPP, n_chains=MLT_CHAINS,
                           render_layer=IPT.FB_COLOR, verbose=False,
                           return_stats=True)
    mlt_s = time.perf_counter() - t0
    n_l, ok = launched18('box')
    off = abs(float(im[..., :3].mean()) / box_mean - 1.0)
    log(f'  render_mlt box {bmt.width}x{bmt.height} colour layer '
        f'{QMC_SPP} spp: {MLT_CHAINS} chains, {st["steps"]} steps, '
        f'{mlt_s:.2f} s ({mlt_s / st["steps"]:.3f} s a step, '
        f'{bmt.width * bmt.height * QMC_SPP / mlt_s / 1e6:.4f} Mmutations/s), '
        f'acceptance {st["acceptance"]:.4f}, average brightness '
        f'{st["avg_brightness"]:.6f}, mean {100 * off:.3f}% off phase 5\'s, '
        f'launches {n_l}, non-finite evaluations {st["nonfinite"]}')
    check(ok and st['nonfinite'] == 0 and np.isfinite(im).all()
          and off <= MEAN_TOL, f'render_mlt box: launches {n_l}, mean '
          f'{100 * off:.3f}% off')
    zero_counts()
    t0 = time.perf_counter()
    mg_img = CLI.render_mlt_merged(bsc, bmt, QMC_SPP, n_chains=MLT_CHAINS,
                                   tile_size=1 << 20)
    merged_s = time.perf_counter() - t0
    n_m, ok_m = launched18('box')
    off_m = abs(float(mg_img[..., :3].mean()) / box_mean - 1.0)
    log(f'  -integrator mlt (QMC direct + MLT indirect) box {QMC_SPP} spp: '
        f'{merged_s:.2f} s, mean {100 * off_m:.3f}% off phase 5\'s, launches '
        f'{n_m}, finite {bool(np.isfinite(mg_img).all())}')
    check(ok_m and np.isfinite(mg_img).all() and off_m <= MEAN_TOL,
          f'merged mlt box: launches {n_m}, mean {100 * off_m:.3f}% off')
    del im, mg_img
    h18, w18 = gm['img'].shape[:2]
    scg, mtg = golden_size(bsc, bmt, w18, h18)
    zero_counts()
    ig = KM.render_mlt(scg, mtg, spp=QMC_SPP, n_chains=MLT_GOLD_CHAINS,
                       render_layer=IPT.FB_COLOR, verbose=False)
    ig2 = CLI.render_mlt_merged(scg, mtg, QMC_SPP)
    n_g, ok_g = launched18('box')
    seeds = {}
    for key, img_, gold_ in (('mlt', ig, gm['img']),
                             ('merged', ig2, gm['merged'])):
        pg, mg = psnr_mean(img_, gold_)
        near = float((np.abs(img_[..., :3] - gold_).max(-1) <= 1e-3).mean())
        seeds[key] = dict(db=pg, mean_off=mg, pixels_near=near)
        log(f'  {key} box {w18}x{h18} {QMC_SPP} spp (the MLT golden\'s size '
            f'and seeds): PSNR {pg:.2f} dB, mean {100 * mg:.4f}% off, '
            f'{near:.6f} of the pixels within 1e-3')
        check(ok_g and pg >= MLT_SEED_PSNR and near >= MOTION_SEED_PIXELS
              and mg <= MEAN_TOL, f'{key} at the golden\'s size: {pg:.2f} '
              f'dB, {near:.6f} of the pixels within 1e-3, mean '
              f'{100 * mg:.4f}% off, launches {n_g}')
    rec18['mlt'] = dict(chains=MLT_CHAINS, steps=st['steps'], seconds=mlt_s,
                        acceptance=st['acceptance'], mean_off=off,
                        launches=n_l, merged_seconds=merged_s,
                        merged_mean_off=off_m, seeds=seeds)
    del box18, bsc, scg, ig, ig2
    at18('MLT checked')

    tmp18 = tempfile.TemporaryDirectory()
    ck = os.path.join(tmp18.name, 'city.npz')
    zero_counts()
    t0 = time.perf_counter()
    R.render(scene, meta, spp=QMC_SPP // 2, integrator='mispt',
             tile_size=1 << 20, checkpoint_path=ck, checkpoint_every=4)
    half_s = time.perf_counter() - t0
    n_h, ok_h = launched18('bench city')
    ck_bytes = os.path.getsize(ck)
    zero_counts()
    im, tm = R.render(scene, meta, spp=QMC_SPP, integrator='mispt',
                      tile_size=1 << 20, checkpoint_path=ck,
                      checkpoint_every=4, resume=True, return_timing=True)
    n_l, ok = launched18('bench city')
    same = bool(np.array_equal(im, city_img))
    log(f'  bench city checkpointed every 4 samples, stopped at '
        f'{QMC_SPP // 2} ({half_s:.2f} s, a {ck_bytes} B checkpoint, '
        f'launches {n_h}) and resumed to {QMC_SPP} ({tm["total_s"]:.2f} s, '
        f'launches {n_l}): equal to phase 4\'s uninterrupted image bit for '
        f'bit {same} (max |d| {float(np.abs(im - city_img).max()):.3e})')
    check(ok_h and ok and same and tm['nonfinite'] == 0,
          f'resumed city render: equal {same}, launches {n_h} then {n_l}')
    rec18['resume'] = dict(bit_exact=same, half_seconds=half_s,
                           resume_seconds=tm['total_s'], ckpt_bytes=ck_bytes,
                           half_launches=n_h, resume_launches=n_l)
    del im
    at18('checkpoint / resume checked')

    out_exr = os.path.join(tmp18.name, 'city.exr')
    cmd = [sys.executable, '-m', 'hydracore3_torch.cli', '-in', city_xml,
           '-out', out_exr, '-spp', str(CLI_SPP), '-tile', str(1 << 20)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('PathTraceBlock(exec) = ')]
    # the subprocess's own launch counts, which it prints after its render
    cli_n = [json.loads(ln.split(' = ', 1)[1])
             for ln in proc.stdout.splitlines()
             if ln.startswith('KernelLaunches = ')]
    cli_n = {k: v for k, v in cli_n[0].items() if v} if cli_n else {}
    cli_route = set(cli_n) == route18['bench city']
    log(f'  python -m hydracore3_torch.cli -in <phase 9\'s city library> '
        f'-out city.exr -spp {CLI_SPP} -tile {1 << 20}: exit '
        f'{proc.returncode} in '
        f'{cli_s:.1f} s (the process included), {lines}, its launches '
        f'{cli_n}')
    check(cli_route, f'the command line\'s launches {cli_n}')
    same_cli = False
    if proc.returncode == 0 and lines and os.path.exists(out_exr):
        exr = IIO.load_exr(out_exr)
        lcity, lcmeta = B.load_scene(city_xml, device=dev)
        zero_counts()
        ref = R.render(lcity, lcmeta, spp=CLI_SPP, integrator='mispt',
                       tile_size=1 << 20)
        n_l, ok = launched18('bench city')
        same_cli = ok and bool(np.array_equal(exr, ref[::-1, :, :3]))
        log(f'  its EXR {exr.shape} read back: equal bit for bit to '
            f'render.render\'s image of the library (flipped to display '
            f'rows, RGB) {same_cli}, max |d| '
            f'{float(np.abs(exr - ref[::-1, :, :3]).max()):.3e}, the '
            f'reference render\'s launches {n_l}')
        del lcity, ref
    else:
        log(f'  its stderr: {proc.stderr[-3000:]}')
    check(same_cli, 'the command line\'s image differs from render.render\'s')
    rec18['cli'] = dict(exit=proc.returncode, seconds=cli_s, equal=same_cli,
                        launches=cli_n)
    tmp18.cleanup()
    libs_dir.cleanup()
    log(f'  phase 18: {time.perf_counter() - t18:.1f} s')

    # ---- 19. differentiable rendering and the camera plugin ---------------
    rec19, dr_box = phase19(dev, (scene, meta), gold_box, gold_city,
                            counters, zero_counts, golden_size)
    # ---- 20. data parallelism, the ray count, the two-level gradient -------
    rec20 = phase20(dev, (scene, meta), city_img, city4, dr_box, counters,
                    zero_counts, first_bounce_queries)
    del dr_box
    # ---- 21. the moving soup (accel='bvh') through K5m ---------------------
    rec21 = phase21(dev, (mb_path, mc_path), counters, zero_counts,
                    first_bounce_queries, query_counts, golden_size,
                    count_lib)
    lib17.cleanup()
    for k_, v_ in rec20['launches'].items():
        launches[{'intersect_stream_tlas': 'intersect_tlas',
                  'intersect_two_level': 'intersect_tlas_motion'}.get(
                      k_, k_)] += v_

    csrc = 'hydracore3_torch/csrc/'
    src = {'intersect_stream': csrc + 'traverse_wide.cuh',
           'intersect_march': csrc + 'traverse_wide.cuh',
           'mega_sample': csrc + 'megakernel.cu',
           'mega_regen': csrc + 'megakernel.cu',
           'intersect_tlas': csrc + 'traverse_wide.cuh',
           'intersect_clusters': csrc + 'traverse_wide.cuh',
           'cell_pass': csrc + 'traverse.cu',
           'intersect_tlas_motion': csrc + 'traverse_wide.cuh'}
    replaces = {'intersect_stream': 'hydracore3_tpu/accel/traverse_stream.py:59',
                'intersect_march': 'hydracore3_tpu/accel/traverse_dda.py:563',
                'mega_sample': 'hydracore3_tpu/models/megakernel.py:2086',
                'mega_regen': 'hydracore3_tpu/models/megakernel.py:2321',
                'intersect_tlas': 'hydracore3_tpu/accel/traverse_tlas.py:49',
                'intersect_clusters':
                    'hydracore3_tpu/accel/traverse_pallas.py:43',
                'cell_pass': 'hydracore3_tpu/accel/traverse_dda.py:179',
                'intersect_tlas_motion':
                    'hydracore3_tpu/accel/two_level.py:201'}
    kernels = [dict(name=n, route='cuda', source=src[n], replaces=replaces[n],
                    launches=launches[n], max_abs_err=errs[n], ms=ms[n],
                    plain_ms=plain_ms[n], bound_ms=bounds[n][0],
                    bound_by=bounds[n][1], library_ms=None) for n in src]
    # K1's spectral variant, its own entries: the spectral box's mispt
    # figures (phase 14), its main path's launches those of the mispt
    # renders, the other integrators' beside them
    for n in ('mega_sample', 'mega_regen'):
        r = spec_rec['mispt']
        kernels.append(dict(
            name=n + '_spectral', route='cuda', source=src[n],
            replaces=replaces[n], launches=r[n]['launches'],
            max_abs_err=max(x['max_abs_err'][n] for x in spec_rec.values()),
            ms=r[n]['ms'], plain_ms=r[n]['plain_ms'],
            bound_ms=r[n]['bound_ms'], bound_by=r[n]['bound_by'],
            library_ms=None, variant=r['variant'],
            registers=r['registers'][n + '_kernel'],
            spectral_box={k: dict(x[n], variant=x['variant'],
                                  registers=x['registers'][n + '_kernel'])
                          for k, x in spec_rec.items()},
            spectral_box2=rec15 if n == 'mega_sample' else None))
    # K1's entries carry the zoo box's figures too (phase 10), per
    # integrator; K5's the zoo box II's (phase 12), whose mispt render's
    # launches its count includes
    for k in kernels:
        if k['name'] == 'intersect_clusters':
            k['zoo_box2'] = rec12
            k['feature_box'] = {c: rec16[c] for c in rec16 if c != 'city'}
        if k['name'] in ('intersect_stream', 'intersect_march'):
            k['feature_city'] = rec16['city']
            k['qmc_city'] = rec18['qmc']['bench city']
            k['resume_cli'] = dict(resume=rec18['resume'],
                                   cli=rec18['cli'])
        if k['name'] == 'intersect_clusters':
            k['qmc_mlt_box'] = dict(qmc=rec18['qmc']['box'],
                                    mlt=rec18['mlt'])
        if k['name'] == 'intersect_clusters':
            k['dr_plugin_box'] = dict(
                {key: rec19[key] for key in 'abcdef'}, hit=rec19['hit'],
                plugin=rec19['plugin']['box'])
        if k['name'] in ('intersect_stream', 'intersect_march'):
            k['plugin_city'] = rec19['plugin']['bench city']
        if k['name'] in ('intersect_stream', 'intersect_march'):
            k['data_parallel_city'] = rec20['b']
            k['count_rays_pass'] = rec20['d']
        if k['name'] == 'intersect_clusters':
            k['data_parallel_dr'] = rec20['c']
        if k['name'] == 'intersect_tlas':
            k['two_level_grad'] = {
                key: v for key, v in rec20['e'].items()
                if key.startswith('K4,')}
        if k['name'] == 'intersect_tlas_motion':
            k['two_level_grad'] = {
                key: v for key, v in rec20['e'].items()
                if key.startswith('K4m')}
        if k['name'] == 'intersect_tlas_motion':
            k.update(registers=rec17['registers'],
                     motion_box=rec17['motion_box'],
                     motion_city=rec17['motion_city'])
        if k['name'] == 'intersect_clusters':
            k['whitted_gbuffer_layers'] = {
                key: v for key, v in rec17.items()
                if key.startswith('rt_') or key == 'layers'}
        if k['name'] in ('mega_sample', 'mega_regen'):
            k['zoo_box'] = {n: dict(r[k['name']], variant=r['variant'],
                                    registers=r['registers'][
                                        k['name'] + '_kernel'])
                            for n, r in zoo_rec.items()}
    # K5m, the moving soup's kernel (phase 21): the motion box's camera
    # query's figures, the launches of the full-frame renders
    mb21 = rec21['motion_box']['camera nearest']
    kernels.append(dict(
        name='intersect_clusters_motion', route='cuda',
        source=csrc + 'traverse_wide.cuh',
        replaces='hydracore3_tpu/accel/traverse.py:99',
        launches=rec21['launches'], max_abs_err=max(
            v['max_abs_err'] for r in ('motion_box', 'motion_city')
            for v in rec21[r].values() if isinstance(v, dict)),
        ms=mb21['ms'], plain_ms=mb21['plain_ms'], bound_ms=mb21['bound_ms'],
        bound_by=mb21['bound_by'], library_ms=None,
        registers=rec21['registers'], motion_box=rec21['motion_box'],
        motion_city=rec21['motion_city']))
    if DEFERRED:
        raise RuntimeError('; '.join(DEFERRED))
    log(f'chip_smoke: {time.perf_counter() - t_start:.1f} s from the first '
        'phase to the last')
    log(card)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
