"""Host-side BVH build: port of ``yuki_tpu/bvh.py``'s ``BvhHost`` and
``build_bvh`` (:62-147).

Build semantics follow the reference (yuki/src/bvh.rs:305-522): recursive
top-down build over primitive centroids with the 12-bucket SAH, the
centroid-midpoint or the equal-counts split, falling back to equal counts
on degenerate splits; leaves are capped at ``max_leaf_size`` primitives.
The build runs in the native C++ builder (``native/bvh_builder.cpp``);
``links`` holds yuki_tpu's octant-threaded (hit, miss) tables.

On the host its root box gives the scene bounds and its leaf order is
what ``treelets.build_treelets`` cuts; ``node_bounds`` gives the boxes of
one tree level for the viewer's BVH overlay.  ``BvhHost.to_device`` gives
``BvhArrays`` (:40-48), the threaded BVH on the scene's device that
``traverse.intersect_bvh`` and ``any_intersect_bvh`` walk: one node id a
ray, the octant's hit link on a box hit, its miss link otherwise.

``build_bvh(..., use_native=False)`` builds in numpy instead (yuki_tpu's
fallback builder, bvh.py:106-282).  It is chosen explicitly: a failed
native build raises and names the missing compiler, where yuki_tpu falls
back quietly.  Its trees equal the native builder's field for field: it
computes in float32 as the C++ does (the SAH's buckets by a multiply with
the reciprocal of the centroid extent, its costs in float32), breaks axis
ties as the C++ does, and reorders the primitives as libstdc++'s
``std::partition`` and ``std::nth_element`` (introselect) do, which fix
the leaf order and, at equal centroids, the split's members.  yuki_tpu's
numpy builder differs there (``np.argpartition``, float64 costs, the first
largest axis), so its trees are not the native ones on such inputs.
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

    def node_bounds(self, level: int) -> tuple[np.ndarray, np.ndarray]:
        """Boxes (lo, hi) of the nodes at tree depth ``level`` and of the
        leaves above it, for the BVH overlay (bvh.rs:121-157)."""
        sel = (self.depth == level) | ((self.depth < level)
                                       & (self.prim_count > 0))
        return self.node_lo[sel], self.node_hi[sel]

    def to_device(self, device) -> BvhArrays:
        """The walk's arrays on ``device``, bit for bit."""
        return BvhArrays(**{
            name: torch.as_tensor(np.ascontiguousarray(getattr(self, name)),
                                  device=device)
            for name in ("node_lo", "node_hi", "prim_offset", "prim_count",
                         "links", "prim_order")})


def build_bvh(tri_p: np.ndarray, split_method: str = "sah",
              max_shapes_in_node: int = 1, max_leaf_size: int = 4,
              use_native: bool = True) -> BvhHost:
    """Build over the triangle soup tri_p [T,3,3] (corner-major) with the
    native builder, or with the numpy one when ``use_native`` is False."""
    lo = tri_p.min(axis=1).astype(np.float32)  # [T,3]
    hi = tri_p.max(axis=1).astype(np.float32)
    build = native_build_bvh if use_native else numpy_build_bvh
    fields = build(lo, hi, split_method, max(1, int(max_shapes_in_node)),
                   int(max_leaf_size))
    return BvhHost(max_leaf=int(fields["prim_count"].max()), **fields)


# --- the numpy builder ------------------------------------------------------

_BUCKETS = 12
_F32 = np.float32


def _swap(ids, keys, i, j):
    ids[i], ids[j] = ids[j], ids[i]
    keys[i], keys[j] = keys[j], keys[i]


def _partition(ids, keys, pred):
    """libstdc++'s ``std::partition`` (the bidirectional form, which a
    random-access range takes) of ids/keys in place by the bool array
    ``pred``: the k-th element failing it from the left swaps with the
    k-th passing it from the right while the first lies left of the
    second.  Returns the count that pass."""
    fails = np.flatnonzero(~pred)
    passes = np.flatnonzero(pred)[::-1]
    m = min(fails.size, passes.size)
    s = int(np.count_nonzero(fails[:m] < passes[:m]))
    a, b = fails[:s], passes[:s]
    ids[a], ids[b] = ids[b], ids[a].copy()
    keys[a], keys[b] = keys[b], keys[a].copy()
    return passes.size


def _unguarded_partition(ids, keys, first, last, pivot):
    """libstdc++'s ``__unguarded_partition`` of [first, last) around the
    key at ``pivot``: from the left, stops at keys not below it; from the
    right, at keys not above it; swap and go on until they cross.  Pairs
    the stops of the original keys, as the scans meet them."""
    p = keys[pivot]
    seg = keys[first:last]
    lefts = first + np.flatnonzero(~(seg < p))
    rights = first + np.flatnonzero(~(p < seg))[::-1]
    m = min(lefts.size, rights.size)
    s = int(np.count_nonzero(lefts[:m] < rights[:m]))
    a, b = lefts[:s], rights[:s]
    ids[a], ids[b] = ids[b], ids[a].copy()
    keys[a], keys[b] = keys[b], keys[a].copy()
    guard = rights[s - 1] if s else last
    if s < lefts.size and lefts[s] < guard:
        return int(lefts[s])
    return int(guard)


def _move_median_to_first(ids, keys, result, a, b, c):
    k = keys
    if k[a] < k[b]:
        if k[b] < k[c]:
            _swap(ids, keys, result, b)
        elif k[a] < k[c]:
            _swap(ids, keys, result, c)
        else:
            _swap(ids, keys, result, a)
    elif k[a] < k[c]:
        _swap(ids, keys, result, a)
    elif k[b] < k[c]:
        _swap(ids, keys, result, c)
    else:
        _swap(ids, keys, result, b)


def _adjust_heap(ids, keys, first, hole, length, val):
    """libstdc++'s ``__adjust_heap`` + ``__push_heap`` on [first, first +
    length); ``val`` is an (id, key) pair."""
    top = hole
    child = hole
    while child < (length - 1) // 2:
        child = 2 * (child + 1)
        if keys[first + child] < keys[first + child - 1]:
            child -= 1
        ids[first + hole] = ids[first + child]
        keys[first + hole] = keys[first + child]
        hole = child
    if length % 2 == 0 and child == (length - 2) // 2:
        child = 2 * (child + 1)
        ids[first + hole] = ids[first + child - 1]
        keys[first + hole] = keys[first + child - 1]
        hole = child - 1
    parent = (hole - 1) // 2
    while hole > top and keys[first + parent] < val[1]:
        ids[first + hole] = ids[first + parent]
        keys[first + hole] = keys[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    ids[first + hole], keys[first + hole] = val


def _heap_select(ids, keys, first, middle, last):
    """libstdc++'s ``__heap_select``: a max-heap of [first, middle), then
    every later key below its top replaces it."""
    length = middle - first
    if length >= 2:
        parent = (length - 2) // 2
        while True:
            _adjust_heap(ids, keys, first, parent, length,
                         (ids[first + parent], keys[first + parent]))
            if parent == 0:
                break
            parent -= 1
    for i in range(middle, last):
        if keys[i] < keys[first]:
            val = (ids[i], keys[i])
            ids[i], keys[i] = ids[first], keys[first]
            _adjust_heap(ids, keys, first, 0, length, val)


def _nth_element(ids, keys, nth):
    """libstdc++'s ``std::nth_element`` (introselect) of ids by keys in
    place: median-of-three pivots and unguarded partitions while more
    than three elements remain, a heap select once 2 * floor(log2 n)
    partitions have not finished it, then an insertion sort (stable)."""
    first, last = 0, ids.size
    if first == last or nth == last:
        return
    depth = 2 * (last.bit_length() - 1)
    while last - first > 3:
        if depth == 0:
            _heap_select(ids, keys, first, nth + 1, last)
            _swap(ids, keys, first, nth)
            return
        depth -= 1
        mid = first + (last - first) // 2
        _move_median_to_first(ids, keys, first, first + 1, mid, last - 1)
        cut = _unguarded_partition(ids, keys, first + 1, last, first)
        if cut <= nth:
            first = cut
        else:
            last = cut
    perm = np.argsort(keys[first:last], kind="stable")
    ids[first:last] = ids[first:last][perm]
    keys[first:last] = keys[first:last][perm]


def _bound(x, reduce):
    """``reduce`` (np.min or np.max) of x [k, 3] over axis 0 as the C++'s
    running std::min / std::max gives it: of equal values the first in
    order is kept, which decides the sign of a zero bound."""
    m = reduce(x, axis=0)
    if m.all():
        return m
    for ax in np.flatnonzero(m == 0):
        col = x[:, ax]
        m[ax] = col[np.flatnonzero(col == 0)[0]]
    return m


def _surface_area(lo, hi):
    """float32 box areas over the trailing axis, in the C++ order."""
    d = np.maximum(hi - lo, _F32(0.0))
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return _F32(2.0) * (dx * dy + dz * dy + dx * dz)


def _sah_split(lo, hi, ids, cent_a, ca_lo, ca_hi, b_lo, b_hi):
    """The 12-bucket SAH (bvh.rs:452-522) on the range's prims, in float32
    as the C++ computes it: (partition count, or -1 for a leaf, or 0 for
    a range of at most two prims, whose caller splits by counts)."""
    count = ids.size
    if count <= 2:
        return 0
    inv = _F32(1.0) / (ca_hi - ca_lo)
    bucket = np.minimum(np.maximum(
        _F32(_BUCKETS) * ((cent_a - ca_lo) * inv), _F32(0.0)).astype(
        np.int64), _BUCKETS - 1)
    counts = np.bincount(bucket, minlength=_BUCKETS)
    blo = np.full((_BUCKETS, 3), np.inf, dtype=_F32)
    bhi = np.full((_BUCKETS, 3), -np.inf, dtype=_F32)
    np.minimum.at(blo, bucket, lo[ids])
    np.maximum.at(bhi, bucket, hi[ids])
    pre_lo = np.minimum.accumulate(blo, axis=0)[:-1]
    pre_hi = np.maximum.accumulate(bhi, axis=0)[:-1]
    suf_lo = np.minimum.accumulate(blo[::-1], axis=0)[::-1][1:]
    suf_hi = np.maximum.accumulate(bhi[::-1], axis=0)[::-1][1:]
    c0 = np.cumsum(counts)[:-1]
    c1 = count - c0
    sa = _surface_area(np.concatenate([pre_lo, suf_lo, b_lo[None]]),
                       np.concatenate([pre_hi, suf_hi, b_hi[None]]))
    sa0 = np.where(c0 > 0, sa[:_BUCKETS - 1], _F32(0.0))
    sa1 = np.where(c1 > 0, sa[_BUCKETS - 1:-1], _F32(0.0))
    total_sa = max(sa[-1], _F32(1e-10))
    cost = _F32(1.0) + (c0.astype(_F32) * sa0 + c1.astype(_F32) * sa1) / (
        total_sa)
    best = int(np.argmin(cost))
    if not cost[best] < _F32(count):
        return -1
    return bucket <= best


def numpy_build_bvh(lo: np.ndarray, hi: np.ndarray, split_method: str,
                    max_shapes_in_node: int, max_leaf_size: int) -> dict:
    """The native builder's algorithm in numpy over per-primitive boxes
    lo/hi [n,3] f32: a preorder build (child 0's subtree before child
    1's), leaves of at most max_shapes_in_node prims, fatter ones split
    when the centroids coincide or the SAH calls a leaf.  Returns the
    BvhHost field dict, links threaded as the native ``thread_links``."""
    split = {"sah": 0, "middle": 1, "equal_counts": 2}.get(split_method)
    if split is None:
        raise ValueError(f"unknown split method {split_method!r}")
    n = lo.shape[0]
    if n <= 0:
        raise RuntimeError(f"numpy build_bvh: {n} prims")
    lo = np.ascontiguousarray(lo, dtype=_F32)
    hi = np.ascontiguousarray(hi, dtype=_F32)
    max_shapes = max(1, max_shapes_in_node)
    max_leaf = max(max_shapes, max_leaf_size)
    cent = _F32(0.5) * (lo + hi)
    order = np.arange(n, dtype=np.int32)
    node_lo, node_hi, off, cnt, ch0, ch1, axes, depth = ([] for _ in range(8))
    ordered = []
    stack = [(0, n, 0, -1, 0)]  # start, end, depth, parent, which child
    while stack:
        start, end, dep, parent, which = stack.pop()
        node = len(node_lo)
        if parent >= 0:
            (ch0 if which == 0 else ch1)[parent] = node
        ids = order[start:end]
        if end - start == 1:
            node_lo.append(lo[ids[0]])
            node_hi.append(hi[ids[0]])
        else:
            node_lo.append(_bound(lo[ids], np.min))
            node_hi.append(_bound(hi[ids], np.max))
        off.append(0)
        cnt.append(0)
        ch0.append(-1)
        ch1.append(-1)
        axes.append(0)
        depth.append(dep)
        count = end - start
        leaf = count <= max_shapes
        if not leaf:
            c = cent[ids]
            c_lo, c_hi = c.min(axis=0), c.max(axis=0)
            dx, dy, dz = c_hi - c_lo
            a = 0 if (dx > dy and dx > dz) else (1 if dy > dz else 2)
            ca_lo, ca_hi = c_lo[a], c_hi[a]
            mid = None
            if ca_hi == ca_lo:
                leaf = count <= max_leaf
                mid = start + count // 2
            elif split == 0:
                pred = _sah_split(lo, hi, ids, c[:, a], ca_lo, ca_hi,
                                  node_lo[node], node_hi[node])
                if isinstance(pred, int) and pred < 0:
                    leaf = count <= max_leaf
                elif not isinstance(pred, int):
                    mid = start + _partition(ids, c[:, a].copy(), pred)
            elif split == 1:
                mid_value = _F32(0.5) * (ca_lo + ca_hi)
                mid = start + _partition(ids, c[:, a].copy(),
                                         c[:, a] < mid_value)
            if not leaf and (mid is None or mid in (start, end)):
                mid = start + count // 2
                _nth_element(ids, c[:, a].copy(), count // 2)
        if leaf:
            off[node] = len(ordered)
            cnt[node] = count
            ordered.extend(ids.tolist())
            continue
        axes[node] = a
        stack.append((mid, end, dep + 1, node, 1))
        stack.append((start, mid, dep + 1, node, 0))
    i32 = dict(dtype=np.int32)
    out = dict(node_lo=np.stack(node_lo).astype(_F32),
               node_hi=np.stack(node_hi).astype(_F32),
               prim_offset=np.asarray(off, **i32),
               prim_count=np.asarray(cnt, **i32),
               child0=np.asarray(ch0, **i32), child1=np.asarray(ch1, **i32),
               axis=np.asarray(axes, **i32), depth=np.asarray(depth, **i32),
               prim_order=np.asarray(ordered, **i32))
    out["links"] = thread_links(out["child0"], out["child1"], out["axis"],
                                out["prim_count"])
    return out


def thread_links(child0, child1, axis, prim_count) -> np.ndarray:
    """Per-octant (hit, miss) links [8, M, 2] (bvh.py ``_thread_links``):
    octant o's bit k set means a negative direction on axis k; an interior
    node's hit link is its near child for that octant, every node's miss
    link skips its subtree, and -1 ends the walk."""
    m = len(child0)
    links = np.zeros((8, m, 2), dtype=np.int32)
    is_leaf = prim_count > 0
    for o in range(8):
        neg = [(o >> k) & 1 for k in range(3)]
        hit = np.full(m, -1, dtype=np.int32)
        miss = np.full(m, -1, dtype=np.int32)
        stack = [(0, -1)]
        while stack:
            node, miss_t = stack.pop()
            miss[node] = miss_t
            if is_leaf[node]:
                hit[node] = miss_t
                continue
            c0, c1 = child0[node], child1[node]
            near, far = (c1, c0) if neg[axis[node]] else (c0, c1)
            hit[node] = near
            stack.append((far, miss_t))
            stack.append((near, far))
        links[o, :, 0] = hit
        links[o, :, 1] = miss
    return links
