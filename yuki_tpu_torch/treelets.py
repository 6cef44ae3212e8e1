"""Two-level treelet structure for large scenes: port of
``yuki_tpu/treelets.py`` (:34-192).

The built BVH is cut, in DFS order, into subtrees of at most
``super_size`` triangles ("supers") and those into subtrees of at most
``leaf_size`` triangles ("treelets"), each padded to exactly
``leaf_size`` triangle rows.  The reference BVH build appends leaf
primitives in DFS order, so each subtree's triangles are contiguous in
``prim_order`` and the cut needs no re-sorting.  The walk
(``ops/trace_treelets.py``) visits supers in order, then their treelets,
then each treelet's rows in order.

Layout change from yuki_tpu: the triangle rows are ``[T*K, 12]`` f32
(p0, p1, p2 | area_light | prim_id | pad) instead of ``[T*K, 128]``; the
128-column padding existed only for the TPU's DMA alignment.  Columns
0-10 hold yuki_tpu's values, including the padding rows' light id -3 and
prim id -1.

``pack_chunks`` (chunk mode, super_size == leaf_size only) greedily
merges DFS-consecutive cut subtrees into one chunk while their prim count
fits leaf_size, as yuki_tpu's (:63-130).  yuki_tpu measured it a
negative (fewer chunks, looser boxes, more crossings a ray) and uses it
only in a benchmark; no scene build here passes it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .bvh import BvhHost
from .device import resolve_device

ROW_COLS = 12


@dataclass
class TreeletArrays:
    """The two-level structure + padded triangle rows, on one device."""

    super_bounds: Any  # [S, 8] f32: lo(3), hi(3), pad
    super_range: Any  # [S, 2] i32: first treelet, treelet count
    treelet_bounds: Any  # [T, 8] f32
    rows: Any  # [T*K, 12] f32: p0, p1, p2 | area_light | prim_id | pad
    leaf_size: int  # K
    n_supers: int
    n_treelets: int
    ts_max: int = 0  # max treelets in any one super


def build_treelets(bvh: BvhHost, tri_p: np.ndarray, tri_light: np.ndarray,
                   leaf_size: int = 16, super_size: int = 2048,
                   pack_chunks: bool = False, device=None) -> TreeletArrays:
    """Cut the built BVH into supers/treelets (host numpy), then move the
    tables to ``device`` (None: ``device.default_device()``).
    ``pack_chunks``: merge consecutive cut subtrees into chunks of at most
    leaf_size prims, each chunk its own super."""
    n_nodes = len(bvh.child0)

    # Subtree prim counts + first-prim offsets via reverse topological
    # order (children always have higher indices than parents in the
    # build's preorder numbering).
    counts = bvh.prim_count.astype(np.int64).copy()
    first = bvh.prim_offset.astype(np.int64).copy()
    for n in range(n_nodes - 1, -1, -1):
        c0, c1 = bvh.child0[n], bvh.child1[n]
        if c0 >= 0:
            counts[n] = counts[c0] + counts[c1]
            first[n] = min(first[c0], first[c1])

    def cut(root, limit):
        """DFS roots of the subtrees under ``root`` small enough for
        ``limit`` (or leaves)."""
        roots = []
        stack = [root]
        while stack:
            n = stack.pop()
            if counts[n] <= limit or bvh.child0[n] < 0:
                roots.append(n)
            else:
                stack.append(bvh.child1[n])
                stack.append(bvh.child0[n])
        return roots

    super_roots = cut(0, super_size)
    order = np.argsort(first[super_roots], kind="stable")  # DFS == prim order
    super_roots = [super_roots[i] for i in order]

    treelets = []  # (lo, hi, prim_start, prim_count)
    super_rows = []  # (lo, hi, t_first, t_count)
    if pack_chunks:
        if super_size != leaf_size:
            raise ValueError("pack_chunks is chunk mode only: super_size "
                             f"{super_size} != leaf_size {leaf_size}")
        groups, cur, cur_n = [], [], 0
        for n in super_roots:
            c = int(counts[n])
            if cur and cur_n + c > leaf_size:
                groups.append(cur)
                cur, cur_n = [], 0
            cur.append(n)
            cur_n += c
        if cur:
            groups.append(cur)
        for g in groups:
            lo = np.min([bvh.node_lo[n] for n in g], axis=0)
            hi = np.max([bvh.node_hi[n] for n in g], axis=0)
            start = int(min(first[n] for n in g))
            count = int(sum(counts[n] for n in g))
            super_rows.append((lo, hi, len(treelets), 1))
            treelets.append((lo, hi, start, count))
        super_roots = []
    for sr in super_roots:
        t_first = len(treelets)
        local = cut(sr, leaf_size)
        local.sort(key=lambda n: first[n])
        for n in local:
            treelets.append(
                (bvh.node_lo[n], bvh.node_hi[n], int(first[n]), int(counts[n]))
            )
        super_rows.append((bvh.node_lo[sr], bvh.node_hi[sr], t_first,
                           len(local)))

    n_t = len(treelets)
    k = leaf_size
    # Padding rows are all-zero degenerate triangles that also carry prim
    # id -1 (kernels mask them by id, not by area) and light id -3 (never
    # a shadow ray's skip id).
    rows = np.zeros((n_t * k, ROW_COLS), dtype=np.float32)
    rows[:, 9] = -3.0
    rows[:, 10] = -1.0
    t_bounds = np.zeros((n_t, 8), dtype=np.float32)
    for ti, (lo, hi, start, count) in enumerate(treelets):
        t_bounds[ti, 0:3] = lo
        t_bounds[ti, 3:6] = hi
        ids = bvh.prim_order[start:start + count]
        r0 = ti * k
        rows[r0:r0 + count, 0:9] = tri_p[ids].reshape(count, 9)
        rows[r0:r0 + count, 9] = tri_light[ids]
        rows[r0:r0 + count, 10] = ids

    s_bounds = np.zeros((len(super_rows), 8), dtype=np.float32)
    s_range = np.zeros((len(super_rows), 2), dtype=np.int32)
    for si, (lo, hi, t0, tc) in enumerate(super_rows):
        s_bounds[si, 0:3] = lo
        s_bounds[si, 3:6] = hi
        s_range[si] = (t0, tc)

    dev = resolve_device(device)
    return TreeletArrays(
        super_bounds=torch.as_tensor(s_bounds, device=dev),
        super_range=torch.as_tensor(s_range, device=dev),
        treelet_bounds=torch.as_tensor(t_bounds, device=dev),
        rows=torch.as_tensor(rows, device=dev),
        leaf_size=k,
        n_supers=len(super_rows),
        n_treelets=n_t,
        ts_max=int(s_range[:, 1].max()) if len(super_rows) else 0,
    )
