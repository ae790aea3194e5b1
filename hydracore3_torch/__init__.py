"""HydraCore3 in PyTorch: the path tracer on NVIDIA Hopper.

This package is the PyTorch/CUDA counterpart of ``hydracore3_tpu`` and
mirrors its module names.  It covers the path tracer in RGB and spectral
mode, whose scene build (``scene/build.py``, JAX's ``'auto'`` rules) sends
a scene down one of five routes, each through hand-written CUDA kernels
for ``sm_90a`` (the fifth, moving instances, below):

* small scenes (fewer than 4096 triangles, the Cornell-class box of
  ``scene/synth.box_scene``): the megakernel (``models/megakernel.py``,
  ``csrc/megakernel.cu``) runs a whole sample per lane, or keeps lanes
  persistent in regen mode; what its gate refuses (a blend, plastic or
  thin film, an importance-sampled sky, ...) the batched integrator
  renders over the cluster-BVH query and the soup's own rows;
* mid-size scenes (4,096-175,000 triangles): the batched integrator
  (``models/integrator_pt.py``) over the cluster-BVH query
  (``accel/traverse_pallas.py``);
* instanced scenes whose flattened soup would pass 200,000 triangles and
  twice the unique ones (``scene/synth.instanced_city_scene``): the batched
  integrator over the two-level query (``accel/traverse_tlas.py``);
* large streamed scenes (the textured synthetic city,
  ``scene/synth.city_scene``): the batched integrator over the grid march
  (nearest hits, ``accel/traverse_dda.py``) and the stream-BVH walk (shadow
  any-hits, ``accel/traverse_stream.py``).

The ray-query kernels live in ``csrc/traverse.cu`` and
``csrc/traverse_wide.cuh`` and walk the 4-wide tables of
``accel/wide_bvh.py``.  A scene with a moving instance (``<motion
matrix=...>``) goes two-level by time: motion blur through K4's moving
variant (``accel/two_level.py``).  Materials: GLTF (``gltf`` nodes, and the
old-Hydra lambert, lambert|metal, metal and fresnel-coat conversions) with
slot-0 textures, diffuse, conductor, dielectric, old-Hydra glass and the
emissive light-source material on every route; plastic, thin film, blend,
normal maps and GLTF slot-2/3 maps on the batched integrator.  Lights:
rect, disc, point and sphere lights on every route; directional, spot and
IES lights, the projective spot and an importance-sampled sky with a
camera-back texture on the batched integrator.  Cameras: the pinhole, and
on the batched integrator the thin lens and the lens stack.
Hero-wavelength spectral mode (``spectral_mode=True``: SPDs, spectral
textures, the CIE or response-spectra finalize, an N-channel framebuffer)
on both routes.  Besides the three path tracers (``mispt``, ``shadowpt``,
``naivept``) and the ``direct`` / ``indirect`` layers: Whitted ray tracing
and the primary-ray pass (``models/integrator_rt.py``), the G-buffer
(``models/gbuffer.py``), the QMC sampler (``render.render_qmc``,
``ops/qmc.py``), Kelemen MLT (``models/kmlt.py``), differentiable
rendering on ``torch.autograd`` (``models/dr.py``: texel and material-row
gradients through the batched route, the Whitted gradient, the Adam
loops; the hit's gradient of the ray in ``accel/hit_grad.py``) and the
camera plugin (``camera_plugin.py``: ray generators and sensors outside
the renderer, traced from their rays), and data parallelism over
``torch.distributed`` (``parallel/mesh.py``: one process per card, each
rendering a stripe of pixels, DR gradients averaged over the ranks).
What a scene holds
beyond that is refused with ``NotImplementedError``: by the loader, naming
its ``ROADMAP.md`` item, or by the render path.

Entry points: ``scene.build.load_scene(path)`` loads a Hydra XML scene
library (``scene/hydra_xml.py``, ``scene/vsgf.py``);
``api.hr2_create_scene()`` builds a scene in process and ``.commit()``
writes its library (the JAX package's files, byte for byte) and loads it;
``scene.build.build_scene(desc)`` and ``scene.synth.city_scene`` /
``instanced_city_scene`` / ``box_scene`` build a description directly.
Each puts the scene on the CUDA card unless given ``device=``, and
``render.render`` renders it (with ``checkpoint_path`` / ``resume``,
pass-granular checkpoints in ``utils/checkpoint.py``'s files).
``utils/imageio.py`` writes EXR, PNG and BMP files and reads EXR;
``python -m hydracore3_torch.cli`` is the reference's command line.
``models.dr.optimize_texture`` is drmain's loop, and
``camera_plugin.render_with_camera_plugin`` main_with_cam's.
"""
from . import camera_plugin  # noqa: F401
from .models import dr  # noqa: F401
