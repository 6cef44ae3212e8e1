"""Host-side BVH build: port of ``yuki_tpu/bvh.py``'s ``BvhHost`` and
``build_bvh`` (:62-147).

Build semantics follow the reference (yuki/src/bvh.rs:305-522): recursive
top-down build over primitive centroids with the 12-bucket SAH, the
centroid-midpoint or the equal-counts split, falling back to equal counts
on degenerate splits; leaves are capped at ``max_leaf_size`` primitives.
The build runs in the native C++ builder (``native/bvh_builder.cpp``);
``links`` holds yuki_tpu's octant-threaded (hit, miss) tables.

The port uses the BVH only on the host: its root box gives the scene
bounds and its leaf order is what ``treelets.build_treelets`` cuts.  Not
ported yet (ROADMAP Queue 1): the numpy builder (``bvh.py:148-282``, the
JAX package's fallback when no C++ toolchain is present) and the device
arrays plus the threaded walk ``BvhArrays`` / ``traverse.intersect_bvh``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .native import native_build_bvh


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


def build_bvh(tri_p: np.ndarray, split_method: str = "sah",
              max_shapes_in_node: int = 1, max_leaf_size: int = 4) -> BvhHost:
    """Build over the triangle soup tri_p [T,3,3] (corner-major)."""
    lo = tri_p.min(axis=1).astype(np.float32)  # [T,3]
    hi = tri_p.max(axis=1).astype(np.float32)
    fields = native_build_bvh(lo, hi, split_method,
                              max(1, int(max_shapes_in_node)),
                              int(max_leaf_size))
    return BvhHost(max_leaf=int(fields["prim_count"].max()), **fields)
