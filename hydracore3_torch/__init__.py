"""HydraCore3 in PyTorch: the MIS path tracer on NVIDIA Hopper.

This package is the PyTorch/CUDA counterpart of ``hydracore3_tpu`` and
mirrors its module names.  It covers the RGB MIS path tracer, whose scene
build (``scene/build.py``, JAX's ``'auto'`` rules) sends a scene down one of
four routes, each through hand-written CUDA kernels for ``sm_90a``:

* small scenes (fewer than 4096 triangles, the Cornell-class box of
  ``scene/synth.box_scene``): the megakernel (``models/megakernel.py``,
  ``csrc/megakernel.cu``) runs a whole sample per lane, or keeps lanes
  persistent in regen mode;
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
``accel/wide_bvh.py``.  Materials: GLTF (``gltf`` nodes, and the old-Hydra
lambert, lambert|metal, metal and fresnel-coat conversions) with slot-0
textures and the emissive light-source material; lights: rect, point and
sphere lights on every route, and a sky (a constant colour, or a lat-long
map on the batched integrator's routes); a pinhole camera.  What a scene
holds beyond that is refused with ``NotImplementedError``: by the loader,
naming its ``ROADMAP.md`` item, or by the render path.

Entry points: ``scene.build.load_scene(path)`` loads a Hydra XML scene
library (``scene/hydra_xml.py``, ``scene/vsgf.py``);
``api.hr2_create_scene()`` builds a scene in process and ``.commit()``
writes its library (the JAX package's files, byte for byte) and loads it;
``scene.build.build_scene(desc)`` and ``scene.synth.city_scene`` /
``instanced_city_scene`` / ``box_scene`` build a description directly.
Each puts the scene on the CUDA card unless given ``device=``, and
``render.render`` renders it.
"""
