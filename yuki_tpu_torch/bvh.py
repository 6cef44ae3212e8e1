"""Host-side BVH build: port of ``yuki_tpu/bvh.py``'s ``BvhHost`` and
``build_bvh`` (:62-147).

Build semantics follow the reference (yuki/src/bvh.rs:305-522): recursive
top-down build over primitive centroids with the 12-bucket SAH, the
centroid-midpoint or the equal-counts split, falling back to equal counts
on degenerate splits; leaves are capped at ``max_leaf_size`` primitives.
The build runs in the native C++ builder (``native/bvh_builder.cpp``);
``links`` holds yuki_tpu's octant-threaded (hit, miss) tables.

On the host its root box gives the scene bounds and its leaf order is
what ``treelets.build_treelets`` cuts.  ``BvhHost.to_device`` gives
``BvhArrays`` (:40-48), the threaded BVH on the scene's device that
``traverse.intersect_bvh`` and ``any_intersect_bvh`` walk: one node id a
ray, the octant's hit link on a box hit, its miss link otherwise.  Not
ported (ROADMAP Queue 1): the numpy builder (``bvh.py:148-282``, the JAX
package's fallback when no C++ toolchain is present).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .native import native_build_bvh


@dataclass
class BvhArrays:
    """The threaded BVH on a device."""

    node_lo: torch.Tensor  # [M,3] f32
    node_hi: torch.Tensor  # [M,3] f32
    prim_offset: torch.Tensor  # [M] i32 (leaf: first index into prim_order)
    prim_count: torch.Tensor  # [M] i32 (0 = interior)
    links: torch.Tensor  # [8,M,2] i32 per octant (hit, miss); -1 ends
    prim_order: torch.Tensor  # [P] i32 leaf order -> original prim index


@dataclass
class BvhHost:
    """Host numpy BVH: node boxes and ranges, tree structure, octant
    links and the leaf-order primitive permutation."""

    node_lo: np.ndarray  # [M,3] f32
    node_hi: np.ndarray  # [M,3] f32
    prim_offset: np.ndarray  # [M] i32 (leaf: first index into prim_order)
    prim_count: np.ndarray  # [M] i32 (0 = interior)
    child0: np.ndarray  # [M] i32, -1 for leaf
    child1: np.ndarray
    axis: np.ndarray  # [M] i32 split axis
    depth: np.ndarray  # [M] i32 node depth
    links: np.ndarray  # [8,M,2] i32 per octant (hit, miss)
    prim_order: np.ndarray  # [P] i32 leaf order -> original prim index
    max_leaf: int

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.node_lo[0], self.node_hi[0]

    def to_device(self, device) -> BvhArrays:
        """The walk's arrays on ``device``, bit for bit."""
        return BvhArrays(**{
            name: torch.as_tensor(np.ascontiguousarray(getattr(self, name)),
                                  device=device)
            for name in ("node_lo", "node_hi", "prim_offset", "prim_count",
                         "links", "prim_order")})


def build_bvh(tri_p: np.ndarray, split_method: str = "sah",
              max_shapes_in_node: int = 1, max_leaf_size: int = 4) -> BvhHost:
    """Build over the triangle soup tri_p [T,3,3] (corner-major)."""
    lo = tri_p.min(axis=1).astype(np.float32)  # [T,3]
    hi = tri_p.max(axis=1).astype(np.float32)
    fields = native_build_bvh(lo, hi, split_method,
                              max(1, int(max_shapes_in_node)),
                              int(max_leaf_size))
    return BvhHost(max_leaf=int(fields["prim_count"].max()), **fields)
