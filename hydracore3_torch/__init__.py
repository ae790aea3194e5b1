"""HydraCore3 in PyTorch: the MIS path tracer on NVIDIA Hopper.

This package is the PyTorch/CUDA counterpart of ``hydracore3_tpu`` and
mirrors its module names.  It covers the RGB MIS path tracer on the
streamed-BVH scene class (the textured synthetic city, ``scene/synth.py``):
GLTF materials from the old-Hydra lambert conversion with slot-0 diffuse
textures, the emissive light-source material, one rect area light, a
lat-long env map with importance sampling and a pinhole camera.  Ray queries
go through two hand-written CUDA kernels (``csrc/traverse.cu``): a
skip-pointer cluster-BVH walk (``accel/traverse_stream.py``) and a uniform
grid march (``accel/traverse_dda.py``).  Everything else raises
``NotImplementedError``.

Entry points: ``scene.synth.city_scene`` builds a scene on a device and
``render.render`` renders it.
"""
