"""yuki_tpu_torch: the PyTorch + CUDA port of the yuki_tpu renderer.

Mirrors ``yuki_tpu``'s module names so each counterpart is easy to find.
This package imports ``torch`` and never ``jax`` or ``yuki_tpu``: the
machine with the card has no JAX.  Scenes are dataclasses of tensors,
every allocating function takes an explicit ``device``, and the two hot
kernels of the dense path-tracing wave (``ops/path_fused.py``) are
hand-written CUDA C++ for Hopper (``ops/csrc/path_fused.cu``) with a plain
PyTorch twin beside each.

Ported so far (ROADMAP "Slice A"): transforms, camera, film, the uniform
sampler, the dense scene builder and Cornell box, ``PathParams``, the
watertight trace, the per-bounce shading body, the fused wave and the
wave renderer.
"""

from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device"]
