"""yuki_tpu_torch: the PyTorch + CUDA port of the yuki_tpu renderer.

Mirrors ``yuki_tpu``'s module names so each counterpart is easy to find.
This package imports ``torch`` and never ``jax`` or ``yuki_tpu``: the
machine with the card has no JAX.  Scenes are dataclasses of tensors,
every allocating function takes an explicit ``device``, and every hot
kernel is hand-written CUDA C++ for Hopper (``ops/csrc/``) with a plain
PyTorch twin beside it.

Ported so far: ROADMAP "Slice A" (transforms, camera, film, the uniform
sampler, the scene builder and Cornell box, the watertight trace, the
shading body, the fused dense wave, the wave renderer) and "Slice B1"
(the native BVH builder, treelets, the colonnade, the treelet walks,
sphere queries, textures, the shade and resolve kernels and
``integrators.path_li``) and "B2a" (the treelet dispatch's probe, its
divergent branch, the overflow re-run and the walk fallback).
"""

from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
