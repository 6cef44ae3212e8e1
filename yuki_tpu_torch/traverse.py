"""Scene queries: port of ``yuki_tpu/traverse.py``'s ``SceneHit``,
``intersect``, ``any_intersect``, ``intersect_dense``,
``any_intersect_dense``, the threaded BVH walks (``intersect_bvh``,
``any_intersect_bvh``) and the coherence sort (``ray_sort_key``,
``_sorted_call``).

Dense scenes (<= DENSE_TRI_THRESHOLD triangles) sweep every triangle with
``ops/trace.py``'s dense kernels (traverse.py:76-149, :443-444, :685-688).

Treelet-scene queries go through ``yuki_tpu``'s adaptive dispatch
(traverse.py:419-671 and :685-844).  Unless the caller passes
``skip_sort=True`` (``path_li`` does, as yuki_tpu's does), the rays are
first sorted by ``ray_sort_key`` (direction octant, Morton cell of the
origin, direction bits) and the results unsorted (``_sorted_call``):

1. The batch is padded to a multiple of 128 with parked rays (``_pad128``).
2. The interval probe (``ops/trace_rows.row_words_interval``) gives each
   128-ray row's conservative union words, and from them the rows engine's
   pair demand (``_rows_demand``).  A wave within the rows engine's
   capacity is coherent: it takes the row-union walk (``rows_closest_w``,
   ``rows_any_w``) on those words.
3. A divergent wave takes the slot stream (``ops/trace_stream.py``): per-ray
   candidate lists from the two-level cull (``ops/trace_cull.py``) from
   CROSS_2L_MIN_CHUNKS chunks up, else from crossing words; the slot walk;
   the per-ray merge.  With ``WALKER_CLOSEST`` / ``WALKER_ANY`` set it takes
   the bundle walker instead (``ops/trace_walker.py``, traverse.py:485-498
   and :723-735): crossing words of the whole wave, the OR of each 8-ray
   bundle's words, one walk per bundle, no sort, pack or merge.  Both flags
   keep yuki_tpu's default, False.  Without them, a scene built with
   ``bun_closest`` (closest queries without a skip) or ``bun_any`` above 1
   takes the bundle engine there (``ops/trace_bundles.py``,
   traverse.py:510-518 and :738-746): crossing words, the OR of each
   bun-ray bundle's words, and the slot walks on bundle-slot rows.
4. Rays that any engine flags overflow re-run through the wide pass at
   C_WIDE (occlusion: only those not yet occluded, since occlusion is
   monotone in the candidate set), with the slot budget of the overflow
   tier their count selects.
5. A blown budget (slot demand, more than OV_CAP overflow rays, or a wide
   re-run that overflows again) sends the whole wave to the exact treelet
   walk (``ops/trace_treelets.py``).
6. Closest hits get their barycentrics from the winning triangle
   (``_recompute_bary``), for the first ``bary_count`` lanes when given.

Under a profiler the dispatch's stages are spans (``profiling.SCOPES``):
``traverse.sort`` (the sort key, sort and unsort), ``traverse.probe``
(the interval probe and the rows engine's demand), ``traverse.cull``
(the two-level cull, crossing words and the lists drawn from them),
``traverse.layout`` (the overflow compaction, the rows engine's pair
budget, the slot layout and pack), ``traverse.walk`` (the row, slot,
walker and bundle kernels), ``traverse.merge`` (the per-ray merge of slot
results), ``traverse.wide`` (the wide re-run), ``traverse.fallback`` (the
treelet walk) and ``traverse.bary``.

``intersect(skip_light=...)`` serves combined closest + shadow waves: each
lane ignores the triangles of its skip light (the reference's sampled-light
exclusion, bvh.rs:287-293), closest lanes passing -2, which matches no
light, shadow lanes their light's id with the 0.9999 chord as t_max, so
that ``.hit`` is their occlusion.  Every engine takes it: the dense skip
sweep, the ``with_skip`` rows, slot and bundle walks, the wide re-run, and
the fallback, whose treelet walk has no skip: its shadow lanes take prim 0
where ``treelet_any`` finds them occluded and -1 where not
(traverse.py:616-631).

Every engine is exact, so the branches agree on prim and occlusion; the
row and slot engines' t is one IEEE divide of a scaled hit, the walk's a
multiply by a reciprocal, so t may differ by an ulp between them.
``COUNTS`` records calls per branch, overflow rays, wide re-runs,
fallbacks and host reads (``counts()``), and the real lanes that enter
the dispatch (``dispatch_lanes``, before padding) and of those the lanes
of waves sent to the treelet walk (``fallback_lanes``).

``intersect(with_stats=True)`` takes the threaded BVH walk
(``intersect_bvh``, traverse.py:171-228) on every scene, dense or treelet,
and also returns each ray's node steps (the BVHIntersections view).  The
walk is plain tensor code, as yuki_tpu's is XLA code: each step every
live ray slab-tests its node, tests the leaf's primitives up to the
scene's fattest leaf masked, and follows its octant's hit or miss link.
One host read a step ends the loop when no ray is left, as ``jnp.any`` in
the while_loop's cond; rays that have ended drop out of the working set
whenever it halves (each ray's result does not depend on the others).
``any_intersect_bvh`` is the occlusion walk (:845-880), which no
integrator calls (the dispatch serves every occlusion query); the tests
hold the dispatch against it.  ``COUNTS`` adds the walks and their
steps.

Then the spheres, brute-force: a sphere wins a closest hit only when
strictly closer than the triangle hit (traverse.py:660-669), and any
sphere hit occludes (:843).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import profiling
from .profiling import pass_scope
from .intersect import ray_spheres, ray_triangle, slab_test
from .ops import trace_stream as ts
from .ops._build import bump
from .ops.trace import (F32_MAX, any_trace, dense_trace, dense_trace_skip,
                        pack_triangles)
from .ops.trace_bundles import bundle_words, bundles_any_w, bundles_closest_w
from .ops.trace_cull import candidate_lists_fused
from .ops.trace_rows import (QUAD, row_words_interval, rows_any_w,
                             rows_closest_w)
from .ops.trace_treelets import treelet_any, treelet_closest
from .ops.trace_walker import walker_any_w, walker_closest_w
from .vecmath import recip

__all__ = ["F32_MAX", "SceneHit", "any_intersect", "any_intersect_bvh",
           "any_intersect_dense", "counts", "intersect", "intersect_bvh",
           "intersect_dense", "ray_sort_key", "reset_counts"]

# Rows-engine capacity of the dispatch probe (traverse.py:319-320).
_ROWS_C = 160
_ROWS_MULT = 24

# The divergent branch's engine (traverse.py:44-58): True takes the bundle
# walker instead of the slot stream.  Pair budgets per 8-ray bundle as
# (tight, wide) tiers.
WALKER_CLOSEST = False
WALKER_ANY = False
WALKER_MULT = (24, 48)
WALKER_MULT_ANY = (16, 32)

COUNTS = {
    "closest_slot": 0, "closest_rows": 0, "closest_walker": 0,
    "closest_bundle": 0,
    "any_slot": 0, "any_rows": 0, "any_walker": 0, "any_bundle": 0,
    "overflow_rays": 0, "wide_reruns": 0, "fallbacks": 0,
    "dispatch_lanes": 0, "fallback_lanes": 0,
    "bvh_walks": 0, "bvh_steps": 0,
}


def reset_counts() -> None:
    """Zero the dispatch's counters and the port's host-read counters."""
    for k in COUNTS:
        COUNTS[k] = 0
    for k in ts.STATS:
        ts.STATS[k] = 0
    profiling.reset_counts()


def counts() -> dict:
    """The dispatch's counters, with the slot stream's host reads
    (``host_syncs``: the dispatch's and the integrators') and the slot and
    bundle-slot rows it laid out; and the port's host reads by site
    (``host_reads.<site>``, ``profiling.counts()``)."""
    return {**COUNTS, **ts.STATS, **profiling.counts()}


class SceneHit(NamedTuple):
    """Closest hit over the whole scene.  All [N]."""

    hit: torch.Tensor  # bool
    t: torch.Tensor
    prim: torch.Tensor  # i32 triangle index or -1
    sphere: torch.Tensor  # i32 sphere index or -1 (exclusive with prim)
    b0: torch.Tensor
    b1: torch.Tensor


def intersect_dense(scene, o, d, t_max, skip_light=None):
    """Closest hit of a dense scene by the sweep over all its triangles;
    with ``skip_light`` [N] i32 each lane ignores the triangles of its
    light (-2: none).  Returns (t, prim i32, b0, b1)."""
    tris = scene.tris
    tp = pack_triangles(tris.p0, tris.p1, tris.p2)
    if skip_light is None:
        return dense_trace(tp, o, d, t_max)
    return dense_trace_skip(tp, tris.area_light, o, d, t_max, skip_light)


def any_intersect_dense(scene, o, d, t_max, skip_light):
    """Occlusion [N] bool of a dense scene by the sweep over all its
    triangles; those of the lane's ``skip_light`` are ignored."""
    tris = scene.tris
    return any_trace(pack_triangles(tris.p0, tris.p1, tris.p2),
                     tris.area_light, o, d, t_max, skip_light)


def _octant(d):
    """Direction octant: bit a set where d[..., a] < 0 (i32)."""
    neg = (d < 0.0).to(torch.int32)
    return neg[..., 0] | (neg[..., 1] << 1) | (neg[..., 2] << 2)


class _WalkSet:
    """The rays a BVH walk still steps: per-ray tensors ``state`` (the
    walk's loop state, written back into ``out`` when the set shrinks
    and at the end) and ``fixed`` (its inputs), over the lanes ``idx``
    of the full batch."""

    def __init__(self, n, device, state, fixed):
        self.idx = torch.arange(n, device=device)
        self.state, self.fixed = state, fixed
        self.out = {k: v.clone() for k, v in state.items()}

    def write_back(self):
        for k, v in self.state.items():
            self.out[k][self.idx] = v

    def live(self, node) -> int:
        """The number of live rays (one host read, counted); drops the
        ended ones once they are half of the set."""
        bump(COUNTS, "bvh_steps")
        live = node >= 0
        n_live = ts.host_int(live.sum())
        if 0 < n_live <= node.shape[0] // 2:
            self.write_back()
            keep = torch.nonzero(live).squeeze(1)
            self.idx = self.idx[keep]
            for group in (self.state, self.fixed):
                for k in group:
                    group[k] = group[k][keep]
        return n_live


def _bvh_start(scene, o, d):
    """(inverse directions, each ray's row base into the flattened octant
    links, the links [8*M, 2])."""
    bvh = scene.bvh
    if bvh is None:
        raise ValueError("the scene carries no threaded BVH (SceneData.bvh)")
    n_nodes = bvh.node_lo.shape[0]
    return (recip(d), _octant(d).to(torch.int64) * n_nodes,
            bvh.links.reshape(-1, 2))


def _leaf_prim(bvh, offset, k):
    """The k-th primitive of each lane's leaf, its index clamped into
    prim_order (lanes past the leaf's count are masked by the caller)."""
    last = bvh.prim_order.shape[0] - 1
    return bvh.prim_order[torch.clamp(offset + k, max=last).to(torch.int64)]


def _next_node(links, oct_base, nd, box_hit):
    """The octant's hit link on a box hit, its miss link otherwise."""
    link = links[oct_base + nd]
    return torch.where(box_hit, link[:, 0], link[:, 1])


def intersect_bvh(scene, o, d, t_max, max_leaf: int, with_stats=False,
                  skip_light=None):
    """Closest triangle hit by the threaded BVH walk (traverse.py:171-228).
    Returns (t, prim i32, b0, b1[, steps i32: nodes visited]).
    ``skip_light`` [N] i32: each lane ignores the triangles of that area
    light (-2: none)."""
    bvh, tris = scene.bvh, scene.tris
    inv_d, oct_base, links = _bvh_start(scene, o, d)
    n, dev = o.shape[0], o.device
    bump(COUNTS, "bvh_walks")
    fixed = dict(o=o, d=d, inv_d=inv_d, oct_base=oct_base)
    if skip_light is not None:
        fixed["skip"] = skip_light
    ws = _WalkSet(n, dev, dict(
        node=torch.zeros(n, dtype=torch.int32, device=dev),
        t=t_max.to(torch.float32),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        b0=torch.zeros(n, dtype=torch.float32, device=dev),
        b1=torch.zeros(n, dtype=torch.float32, device=dev),
        steps=torch.zeros(n, dtype=torch.int32, device=dev)), fixed)
    st, fx = ws.state, ws.fixed
    while ws.live(st["node"]):
        o_, d_, t = fx["o"], fx["d"], st["t"]
        prim, b0, b1 = st["prim"], st["b0"], st["b1"]
        active = st["node"] >= 0
        nd = torch.clamp(st["node"], min=0).to(torch.int64)
        box_hit = slab_test(o_, fx["inv_d"], t, bvh.node_lo[nd],
                            bvh.node_hi[nd]) & active
        count = bvh.prim_count[nd]
        offset = bvh.prim_offset[nd]
        leaf_live = box_hit & (count > 0)
        # The leaf's primitives, masked up to the fattest leaf.
        for k in range(max_leaf):
            lane = leaf_live & (k < count)
            pidx = _leaf_prim(bvh, offset, k)
            pl = pidx.to(torch.int64)
            th = ray_triangle(o_, d_, t, tris.p0[pl], tris.p1[pl],
                              tris.p2[pl])
            closer = lane & th.hit & (th.t < t)
            if skip_light is not None:
                closer = closer & (tris.area_light[pl] != fx["skip"])
            t = torch.where(closer, th.t, t)
            prim = torch.where(closer, pidx, prim)
            b0 = torch.where(closer, th.b0, b0)
            b1 = torch.where(closer, th.b1, b1)
        nxt = _next_node(links, fx["oct_base"], nd, box_hit)
        st.update(node=torch.where(active, nxt, st["node"]), t=t, prim=prim,
                  b0=b0, b1=b1, steps=st["steps"] + active.to(torch.int32))
    ws.write_back()
    out = ws.out
    res = (out["t"], out["prim"], out["b0"], out["b1"])
    return res + (out["steps"],) if with_stats else res


def any_intersect_bvh(scene, meta, o, d, t_max, skip_light) -> torch.Tensor:
    """Occlusion by the threaded BVH walk (traverse.py:845-880): a lane
    ends at its first blocker, triangles of its ``skip_light`` [N] i32
    passed over; then any sphere hit occludes.  Returns [N] bool."""
    bvh, tris = scene.bvh, scene.tris
    inv_d, oct_base, links = _bvh_start(scene, o, d)
    n, dev = o.shape[0], o.device
    bump(COUNTS, "bvh_walks")
    ws = _WalkSet(n, dev, dict(
        node=torch.zeros(n, dtype=torch.int32, device=dev),
        occ=torch.zeros(n, dtype=torch.bool, device=dev)), dict(
        o=o, d=d, inv_d=inv_d, oct_base=oct_base, t_max=t_max,
        skip=skip_light))
    st, fx = ws.state, ws.fixed
    while ws.live(st["node"]):
        occ = st["occ"]
        active = (st["node"] >= 0) & ~occ
        nd = torch.clamp(st["node"], min=0).to(torch.int64)
        box_hit = slab_test(fx["o"], fx["inv_d"], fx["t_max"],
                            bvh.node_lo[nd], bvh.node_hi[nd]) & active
        count = bvh.prim_count[nd]
        offset = bvh.prim_offset[nd]
        leaf_live = box_hit & (count > 0)
        for k in range(meta.bvh_max_leaf):
            lane = leaf_live & (k < count)
            pl = _leaf_prim(bvh, offset, k).to(torch.int64)
            th = ray_triangle(fx["o"], fx["d"], fx["t_max"], tris.p0[pl],
                              tris.p1[pl], tris.p2[pl])
            occ = occ | (lane & th.hit
                         & (tris.area_light[pl] != fx["skip"]))
        nxt = _next_node(links, fx["oct_base"], nd, box_hit)
        st.update(occ=occ, node=torch.where(
            active, torch.where(occ, -1, nxt), -1).to(torch.int32))
    ws.write_back()
    return ws.out["occ"] | ray_spheres(o, d, t_max, scene.spheres).hit


def _morton_part(x):
    """Spread the low 10 bits of x (u32 in int64) to every third bit."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def ray_sort_key(scene, o, d):
    """yuki_tpu's coherence key (traverse.py:241-285), a u32 in int64,
    bit for bit: the direction octant (bits 21-23), the Morton code of the
    origin's cell in a 32^3 grid over the scene bounds (bits 6-20), and
    two bits per axis of |d| normalised by its largest component (bits
    0-5; shadow directions arrive unnormalised).  The divides are tensor
    divides, as XLA computes them (torch turns ``scalar / tensor`` into a
    reciprocal multiply on the card); each float-to-u32 cast truncates
    after its clip, as JAX's does."""
    f32 = dict(dtype=torch.float32, device=o.device)
    lo = scene.world_lo
    ext = torch.maximum(scene.world_hi - lo, torch.tensor(1e-6, **f32))
    inv_ext = torch.tensor(31.0, **f32) / ext
    cell = torch.clamp((o - lo) * inv_ext, 0, 31).to(torch.int64)
    morton = ((_morton_part(cell[..., 0]) << 2)
              | (_morton_part(cell[..., 1]) << 1)
              | _morton_part(cell[..., 2]))
    ad = torch.abs(d)
    ad = ad / torch.maximum(ad.amax(dim=-1, keepdim=True),
                            torch.tensor(1e-30, **f32))
    db = torch.clamp((ad * torch.tensor(3.999, **f32)).to(torch.int64), 0, 3)
    dir6 = (db[..., 0] << 4) | (db[..., 1] << 2) | db[..., 2]
    return (_octant(d).to(torch.int64) << 21) | (morton << 6) | dir6


def _sorted_call(scene, o, d, t_max, extra, fn, skip_sort: bool = False):
    """fn(o, d, t_max, extra) on the rays sorted by ``ray_sort_key``, its
    outputs unsorted (traverse.py:381-416); ``skip_sort`` calls fn on the
    natural order.  The sort is stable, as jnp.argsort is, and the
    permutation is inverted with one scatter."""
    if skip_sort:
        return tuple(fn(o, d, t_max, extra))
    n = o.shape[0]
    with pass_scope("traverse.sort"):
        order = torch.argsort(ray_sort_key(scene, o, d), stable=True)
        args = (o[order], d[order], t_max[order],
                None if extra is None else extra[order])
    outs = fn(*args)
    with pass_scope("traverse.sort"):
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n, device=order.device)
        return tuple(x[inv] if x.ndim else x for x in outs)


def _rows_demand(row_words):
    """The rows engine's pair demand (traverse.py:323-339): per row the
    popcount clamped to [1, _ROWS_C], aligned to QUAD, summed."""
    pc = ts.popcount32(row_words).sum(dim=-1)
    pc = torch.clamp(pc, 1, _ROWS_C)
    return (-(-pc // QUAD) * QUAD).sum()


def _compact_indices(mask):
    """(indices of the set lanes in ascending order, their count): the
    first ``count`` entries of yuki_tpu's ``_compact_indices``
    (traverse.py:342-353), whose padding only served static shapes.  The
    count is a host read."""
    idx = torch.nonzero(mask).squeeze(1)
    bump(ts.STATS, "host_syncs")
    bump(profiling.COUNTS, "host_reads.dispatch")
    return idx, idx.numel()


def _pad128(scene, o, d, t_max, *extras):
    """Pad a batch to a multiple of 128 with parked rays: origin at the
    scene centre, direction +z, t_max 0, extras -2 (traverse.py:356-378)."""
    n = o.shape[0]
    pad = (-n) % ts.LANES
    if pad == 0:
        return (o, d, t_max) + extras
    center = (0.5 * (scene.world_lo + scene.world_hi)).expand(pad, 3)
    z = torch.tensor([0.0, 0.0, 1.0], device=o.device).expand(pad, 3)
    out = (torch.cat([o, center]), torch.cat([d, z]),
           torch.cat([t_max, torch.zeros(pad, dtype=t_max.dtype,
                                         device=t_max.device)]))
    for e in extras:
        out = out + (torch.cat([e, torch.full((pad,), -2, dtype=e.dtype,
                                              device=e.device)]),)
    return out


def _coherent(row_words) -> bool:
    """The dispatch's branch: the rows engine's demand within its budget."""
    return ts.host_int(_rows_demand(row_words)) <= (
        row_words.shape[0] * _ROWS_MULT)


def _wide_cap(n_ov: int) -> int:
    """The overflow tier that holds n_ov rays (traverse.py:576-591)."""
    for cap in (ts.OV_SMALL, ts.OV_MID):
        if n_ov <= cap:
            return cap
    return ts.OV_CAP


def _probe(ch, o, d, t_max):
    """(the interval probe's row words, whether the wave is coherent)."""
    with pass_scope("traverse.probe"):
        row_words = row_words_interval(ch, o, d, t_max)
        return row_words, _coherent(row_words)


def _overflow_indices(mask):
    """The overflow lanes to re-run (``_compact_indices``), counted."""
    with pass_scope("traverse.layout"):
        idx, n_ov = _compact_indices(mask)
    bump(COUNTS, "overflow_rays", n_ov)
    return idx, n_ov


def _closest_dispatch(scene, meta, o, d, t_max, skip=None, n_bary=None,
                      n_real=None):
    """Triangle closest hit by the adaptive dispatch over padded rays;
    ``skip`` [N] i32 or None (traverse.py:430-638); barycentrics for the
    first ``n_bary`` lanes (None: all), zeros past them.  ``n_real``: the
    lanes before padding (None: all), counted in ``dispatch_lanes``."""
    ch, tl = scene.chunks, scene.treelets
    n_real = o.shape[0] if n_real is None else n_real
    bump(COUNTS, "dispatch_lanes", n_real)
    row_words, coherent = _probe(ch, o, d, t_max)
    if coherent:
        bump(COUNTS, "closest_rows")
        t, prim, ov = rows_closest_w(ch, row_words, o, d, t_max, C=_ROWS_C,
                                     mult=_ROWS_MULT, skip=skip)
        ok = True
    elif WALKER_CLOSEST:
        bump(COUNTS, "closest_walker")
        with pass_scope("traverse.cull"):
            words = ts.cross_words(ch, o, d, t_max)
        with pass_scope("traverse.walk"):
            t, prim, ov, ok = walker_closest_w(
                ch, words, o, d, t_max, mult=WALKER_MULT[0],
                mult_wide=WALKER_MULT[1], skip=skip)
    elif meta.bun_closest > 1 and skip is None:
        bump(COUNTS, "closest_bundle")
        bun = meta.bun_closest
        with pass_scope("traverse.cull"):
            bwords = bundle_words(ts.cross_words(ch, o, d, t_max), bun)
        with pass_scope("traverse.walk"):
            t, prim, ov, ok = bundles_closest_w(
                ch, bwords, o, d, t_max, C=meta.c_closest,
                mult=4 * meta.slot_mult_tight,
                mult_wide=4 * meta.slot_mult + 4, bun=bun)
    else:
        bump(COUNTS, "closest_slot")
        budget = dict(mult=meta.slot_mult_tight, mult_wide=meta.slot_mult,
                      skip=skip)
        if ch.n_treelets >= ts.CROSS_2L_MIN_CHUNKS:
            with pass_scope("traverse.cull"):
                lists, ov = candidate_lists_fused(ch, o, d, t_max, ts.C_MAIN)
            t, prim, ov, ok = ts.stream_closest_l(
                ch, lists, ov, o, d, t_max, C=ts.C_MAIN, **budget)
        else:
            with pass_scope("traverse.cull"):
                words = ts.cross_words(ch, o, d, t_max)
            t, prim, ov, ok = ts.stream_closest_w(
                ch, words, o, d, t_max, C=ts.C_MAIN, **budget)
    if ok:
        idx, n_ov = _overflow_indices(ov)
        if n_ov > ts.OV_CAP:
            ok = False
        elif n_ov:
            # The compacted lanes are all live: yuki_tpu's dead tail of
            # the static cap (skip -2, t_max 0) is not built.
            bump(COUNTS, "wide_reruns")
            with pass_scope("traverse.wide"):
                t_w, p_w, _, _, ov2, ok2 = ts.stream_closest(
                    ch, scene.tris.shading_packed, o[idx], d[idx],
                    t_max[idx], C=ts.C_WIDE,
                    mult=(ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT),
                    mult_wide=ts.C_WIDE, budget_n=_wide_cap(n_ov),
                    skip=None if skip is None else skip[idx])
                t[idx] = t_w
                prim[idx] = p_w
                ok = ok2 and not ts.host_int(ov2.any())
    if not ok:
        bump(COUNTS, "fallbacks")
        bump(COUNTS, "fallback_lanes", n_real)
        with pass_scope("traverse.fallback"):
            t, prim, b0, b1 = treelet_closest(tl, o, d, t_max)
            if skip is not None:
                # The walk has no skip: shadow lanes read only .hit, from
                # the occlusion walk that has one.
                occ = treelet_any(tl, o, d, t_max, skip)
                prim = torch.where(skip != -2, occ.to(torch.int32) - 1, prim)
        return t, prim, b0, b1
    nb = o.shape[0] if n_bary is None else n_bary
    with pass_scope("traverse.bary"):
        b0, b1 = ts._recompute_bary(scene.tris.shading_packed, o[:nb],
                                    d[:nb], t[:nb], prim[:nb])
        if nb < o.shape[0]:
            pad = t.new_zeros(o.shape[0] - nb)
            b0, b1 = torch.cat([b0, pad]), torch.cat([b1, pad])
    return t, prim, b0, b1


def _any_dispatch(scene, meta, o, d, t_max, skip, n_real=None):
    """Triangle occlusion by the adaptive dispatch over padded rays;
    ``n_real`` as for ``_closest_dispatch``."""
    ch, tl = scene.chunks, scene.treelets
    n_real = o.shape[0] if n_real is None else n_real
    bump(COUNTS, "dispatch_lanes", n_real)
    row_words, coherent = _probe(ch, o, d, t_max)
    if coherent:
        bump(COUNTS, "any_rows")
        occ, ov = rows_any_w(ch, row_words, o, d, t_max, skip, C=_ROWS_C,
                             mult=_ROWS_MULT)
        ok = True
    elif WALKER_ANY:
        bump(COUNTS, "any_walker")
        with pass_scope("traverse.cull"):
            words = ts.cross_words(ch, o, d, t_max)
        with pass_scope("traverse.walk"):
            occ, ov, ok = walker_any_w(
                ch, words, o, d, t_max, skip, mult=WALKER_MULT_ANY[0],
                mult_wide=WALKER_MULT_ANY[1])
    elif meta.bun_any > 1:
        bump(COUNTS, "any_bundle")
        bun = meta.bun_any
        with pass_scope("traverse.cull"):
            bwords = bundle_words(ts.cross_words(ch, o, d, t_max), bun)
        with pass_scope("traverse.walk"):
            occ, ov, ok = bundles_any_w(
                ch, bwords, o, d, t_max, skip, C=meta.c_any,
                mult=4 * max(3, meta.slot_mult_tight - 1),
                mult_wide=4 * max(4, meta.slot_mult - 2) + 4, bun=bun)
    else:
        bump(COUNTS, "any_slot")
        budget = dict(mult=max(3, meta.slot_mult_tight - 1),
                      mult_wide=max(4, meta.slot_mult - 2))
        if ch.n_treelets >= ts.CROSS_2L_MIN_CHUNKS:
            with pass_scope("traverse.cull"):
                lists, ov = candidate_lists_fused(ch, o, d, t_max, ts.C_MAIN)
            occ, ov, ok = ts.stream_any_l(ch, lists, ov, o, d, t_max, skip,
                                          C=ts.C_MAIN, **budget)
        else:
            with pass_scope("traverse.cull"):
                words = ts.cross_words(ch, o, d, t_max)
            occ, ov, ok = ts.stream_any_w(ch, words, o, d, t_max, skip,
                                          C=ts.C_MAIN, **budget)
    if ok:
        # An occluded verdict is final even from a cut list: only the
        # unoccluded overflow rays re-run (traverse.py:771-777).
        idx, n_ov = _overflow_indices(ov & ~occ)
        if n_ov > ts.OV_CAP:
            ok = False
        elif n_ov:
            bump(COUNTS, "wide_reruns")
            with pass_scope("traverse.wide"):
                occ_w, ov2, ok2 = ts.stream_any(
                    ch, o[idx], d[idx], t_max[idx], skip[idx], C=ts.C_WIDE,
                    mult=(ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT),
                    mult_wide=ts.C_WIDE, budget_n=_wide_cap(n_ov))
                occ[idx] = occ_w
                ok = ok2 and not ts.host_int((ov2 & ~occ_w).any())
    if not ok:
        bump(COUNTS, "fallbacks")
        bump(COUNTS, "fallback_lanes", n_real)
        with pass_scope("traverse.fallback"):
            return treelet_any(tl, o, d, t_max, skip)
    return occ


def intersect(scene, meta, o, d, t_max, skip_light=None, skip_sort=False,
              bary_count=None, with_stats=False):
    """Full scene closest hit: the dense sweep or the treelet dispatch
    (with ``with_stats``: the threaded BVH walk on either), then the
    spheres.  Returns SceneHit, or (SceneHit, steps [N] i32) with
    ``with_stats``.

    ``skip_light`` [N] i32 (or None): each lane ignores the triangles of
    that area light; -2 matches none (combined closest + shadow waves).
    ``skip_sort``: call the dispatch on the rays' natural order instead of
    sorting them by ``ray_sort_key`` (yuki_tpu's default, False, sorts).
    ``bary_count`` (with ``skip_sort`` only, as in yuki_tpu): barycentrics
    only for the first bary_count lanes rounded up to 128, zeros past them
    unless the wave fell back to the treelet walk."""
    if with_stats:
        t, prim, b0, b1, steps = intersect_bvh(
            scene, o, d, t_max, meta.bvh_max_leaf, True, skip_light)
    elif meta.traversal == "dense":
        t, prim, b0, b1 = intersect_dense(scene, o, d, t_max, skip_light)
    else:
        def run(o, d, t_max, sk):
            n0 = o.shape[0]
            padded = _pad128(scene, o, d, t_max,
                             *(() if sk is None else (sk,)))
            n = padded[0].shape[0]
            nb = None if bary_count is None or not skip_sort else min(
                -(-bary_count // ts.LANES) * ts.LANES, n)
            return tuple(x[:n0] for x in _closest_dispatch(
                scene, meta, *padded[:3],
                skip=None if sk is None else padded[3], n_bary=nb,
                n_real=n0))

        t, prim, b0, b1 = _sorted_call(scene, o, d, t_max, skip_light, run,
                                       skip_sort)
    sh = ray_spheres(o, d, t_max, scene.spheres)
    sphere_wins = sh.hit & (sh.t < t)
    hit = SceneHit(
        hit=(prim >= 0) | sphere_wins,
        t=torch.where(sphere_wins, sh.t, t),
        prim=torch.where(sphere_wins, -1, prim),
        sphere=torch.where(sphere_wins, sh.sphere, -1),
        b0=b0,
        b1=b1,
    )
    return (hit, steps) if with_stats else hit


def any_intersect(scene, meta, o, d, t_max, skip_light,
                  skip_sort=False) -> torch.Tensor:
    """Occlusion: triangles whose area-light id equals the lane's
    ``skip_light`` [N] i32 are ignored (the reference skips the sampled
    light, bvh.rs:287-293); any sphere hit occludes.  ``skip_sort``: as
    for ``intersect``.  Returns [N] bool."""
    if meta.traversal == "dense":
        occ = any_intersect_dense(scene, o, d, t_max, skip_light)
    else:
        def run(o, d, t_max, sk):
            n0 = o.shape[0]
            return (_any_dispatch(scene, meta, *_pad128(
                scene, o, d, t_max, sk), n_real=n0)[:n0],)

        (occ,) = _sorted_call(scene, o, d, t_max, skip_light, run, skip_sort)
    return occ | ray_spheres(o, d, t_max, scene.spheres).hit
