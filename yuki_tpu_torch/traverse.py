"""Scene queries for the path integrator: port of ``yuki_tpu/traverse.py``'s
``SceneHit``, ``intersect`` and ``any_intersect`` for treelet scenes.

This is Slice B1's configuration: every closest-hit and occlusion query
of a treelet scene goes through the exact two-level treelet walk
(``ops/trace_treelets.py``), which is what ``yuki_tpu`` runs for any wave
whose candidate budget blows (traverse.py:616-641 and :826-835).  Every
other engine of ``yuki_tpu``'s adaptive dispatch is an exact query over
the same watertight test, so they agree with this walk; that dispatch
(the row-union walk for coherent waves, the fused cull and slot stream
for divergent ones, the overflow re-run) is Slice B2, the next port.

Then the spheres, brute-force: a sphere wins a closest hit only when
strictly closer than the triangle hit (traverse.py:660-669), and any
sphere hit occludes (:843).  Dense scenes (<= DENSE_TRI_THRESHOLD
triangles) outside the fused wave need ``ops/trace.py``'s dense kernels,
not ported yet (ROADMAP Queue 2 item 3): their queries raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import ray_spheres
from .ops.trace import F32_MAX
from .ops.trace_treelets import treelet_any, treelet_closest

__all__ = ["F32_MAX", "SceneHit", "any_intersect", "intersect"]


class SceneHit(NamedTuple):
    """Closest hit over the whole scene.  All [N]."""

    hit: torch.Tensor  # bool
    t: torch.Tensor
    prim: torch.Tensor  # i32 triangle index or -1
    sphere: torch.Tensor  # i32 sphere index or -1 (exclusive with prim)
    b0: torch.Tensor
    b1: torch.Tensor


def _require_treelet(meta) -> None:
    if meta.traversal != "treelet":
        raise NotImplementedError(
            f"scene queries for traversal {meta.traversal!r} need the dense "
            "trace kernels (ops/trace.py _dense_kernel/_any_kernel), not "
            "ported yet (ROADMAP Queue 2 item 3)"
        )


def intersect(scene, meta, o, d, t_max) -> SceneHit:
    """Full scene closest hit: the treelet walk, then the spheres."""
    _require_treelet(meta)
    t, prim, b0, b1 = treelet_closest(scene.treelets, o, d, t_max)
    sh = ray_spheres(o, d, t_max, scene.spheres)
    sphere_wins = sh.hit & (sh.t < t)
    return SceneHit(
        hit=(prim >= 0) | sphere_wins,
        t=torch.where(sphere_wins, sh.t, t),
        prim=torch.where(sphere_wins, -1, prim),
        sphere=torch.where(sphere_wins, sh.sphere, -1),
        b0=b0,
        b1=b1,
    )


def any_intersect(scene, meta, o, d, t_max, skip_light) -> torch.Tensor:
    """Occlusion: triangles whose area-light id equals the lane's
    ``skip_light`` [N] i32 are ignored (the reference skips the sampled
    light, bvh.rs:287-293); any sphere hit occludes.  Returns [N] bool."""
    _require_treelet(meta)
    occ = treelet_any(scene.treelets, o, d, t_max, skip_light)
    return occ | ray_spheres(o, d, t_max, scene.spheres).hit
