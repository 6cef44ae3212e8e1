"""yuki_tpu_torch: the PyTorch + CUDA port of the yuki_tpu renderer.

Mirrors ``yuki_tpu``'s module names so each counterpart is easy to find.
This package imports ``torch`` and never ``jax`` or ``yuki_tpu``: the
machine with the card has no JAX.  Scenes are dataclasses of tensors,
every allocating function takes an explicit ``device``, and every hot
kernel is hand-written CUDA C++ for Hopper (``ops/csrc/``) with a plain
PyTorch twin beside it.

Ported so far: ROADMAP "Slice A" (transforms, camera, film, the uniform
sampler, the scene builder and Cornell box, the watertight trace, the
shading body, the fused dense wave, the wave renderer), "Slice B1" (the
native BVH builder, treelets, the colonnade, the treelet walks, sphere
queries, textures, the shade and resolve kernels and
``integrators.path_li``), "B2a"/"B2b" (the treelet dispatch: probe, rows,
cull, slot stream, overflow re-run, walk fallback), the dense ``path_li``
route, the bundle walker, the pair walks, the skip queries, the
stratified sampler and the one-kernel wave; then the headless app: the
pbrt, PLY and Mitsuba loaders with the image decoder, the atrium asset
(``scene/atrium.py``), the film's bookkeeping, the threaded ``Renderer``,
``tonemap``, ``profiling``, ``app/`` (settings, scene load dispatch, EXR,
headless render) and ``python -m yuki_tpu_torch``; then the shading chain
(``vecmath``, ``intersect``'s triangle and slab tests, ``surface``,
``bsdf``, ``lights`` and ``path_li``'s chain branch), Whitted, the four
debug views and the threaded BVH on the device with its walks
(``bvh.BvhArrays``, ``traverse.intersect_bvh``, ``any_intersect_bvh``),
so that every integrator and the app's default settings render; then
the web viewer (``app/viewer.py``, the default ``python -m
yuki_tpu_torch``) with its debug rays (``integrators/debug_rays.py``) and
BVH overlay (``bvh.BvhHost.node_bounds``), the bundle engine
(``ops/trace_bundles.py``, behind ``SceneMeta.bun_closest`` /
``bun_any`` > 1), multi-device rendering (``parallel``, asked for
explicitly: the ``Renderer`` renders on the scene's device, where
yuki_tpu's shards each wave over every local device), the numpy BVH
builder (``bvh.build_bvh(use_native=False)``), ``build_treelets``'
``pack_chunks`` and the stand-alone row queries.  The port now does all
that ``yuki_tpu`` does; only yuki_tpu's benchmark probes
(``benchmarks/``) have no counterpart (ROADMAP Queue 2).
"""

from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
