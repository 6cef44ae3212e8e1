"""Scene queries for the path integrator: port of ``yuki_tpu/traverse.py``'s
``SceneHit``, ``intersect``, ``any_intersect``, ``intersect_dense``,
``any_intersect_dense`` and the coherence sort (``ray_sort_key``,
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
   keep yuki_tpu's default, False.  A scene built with ``bun_closest`` or
   ``bun_any`` above 1 would take yuki_tpu's bundle engine there, which is
   not ported: that raises.
4. Rays that any engine flags overflow re-run through the wide pass at
   C_WIDE (occlusion: only those not yet occluded, since occlusion is
   monotone in the candidate set), with the slot budget of the overflow
   tier their count selects.
5. A blown budget (slot demand, more than OV_CAP overflow rays, or a wide
   re-run that overflows again) sends the whole wave to the exact treelet
   walk (``ops/trace_treelets.py``).
6. Closest hits get their barycentrics from the winning triangle
   (``_recompute_bary``), for the first ``bary_count`` lanes when given.

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
fallbacks and host reads (``counts()``).

Then the spheres, brute-force: a sphere wins a closest hit only when
strictly closer than the triangle hit (traverse.py:660-669), and any
sphere hit occludes (:843).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .intersect import ray_spheres
from .ops import trace_stream as ts
from .ops.trace import (F32_MAX, any_trace, dense_trace, dense_trace_skip,
                        pack_triangles)
from .ops.trace_cull import candidate_lists_fused
from .ops.trace_rows import (QUAD, row_words_interval, rows_any_w,
                             rows_closest_w)
from .ops.trace_treelets import treelet_any, treelet_closest
from .ops.trace_walker import walker_any_w, walker_closest_w

__all__ = ["F32_MAX", "SceneHit", "any_intersect", "any_intersect_dense",
           "counts", "intersect", "intersect_dense", "ray_sort_key",
           "reset_counts"]

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
    "any_slot": 0, "any_rows": 0, "any_walker": 0,
    "overflow_rays": 0, "wide_reruns": 0, "fallbacks": 0,
}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    ts.STATS["host_syncs"] = 0


def counts() -> dict:
    """The dispatch's counters, with the host reads of the slot stream."""
    return {**COUNTS, **ts.STATS}


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
    order = torch.argsort(ray_sort_key(scene, o, d), stable=True)
    outs = fn(o[order], d[order], t_max[order],
              None if extra is None else extra[order])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=order.device)
    return tuple(x[inv] if x.ndim else x for x in outs)


def _no_bundle_engine(which: str):
    return NotImplementedError(
        f"meta.{which} > 1 selects yuki_tpu's bundle engine "
        "(ops/trace_bundles.py: the slot layout, _pack_bundles, "
        "bundles_closest_w and bundles_any_w), which is not ported; build "
        f"the scene with {which} = 1")


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
    ts.STATS["host_syncs"] += 1
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


def _closest_dispatch(scene, meta, o, d, t_max, skip=None, n_bary=None):
    """Triangle closest hit by the adaptive dispatch over padded rays;
    ``skip`` [N] i32 or None (traverse.py:430-638); barycentrics for the
    first ``n_bary`` lanes (None: all), zeros past them."""
    ch, tl = scene.chunks, scene.treelets
    row_words = row_words_interval(ch, o, d, t_max)
    if _coherent(row_words):
        COUNTS["closest_rows"] += 1
        t, prim, ov = rows_closest_w(ch, row_words, o, d, t_max, C=_ROWS_C,
                                     mult=_ROWS_MULT, skip=skip)
        ok = True
    elif WALKER_CLOSEST:
        COUNTS["closest_walker"] += 1
        t, prim, ov, ok = walker_closest_w(
            ch, ts.cross_words(ch, o, d, t_max), o, d, t_max,
            mult=WALKER_MULT[0], mult_wide=WALKER_MULT[1], skip=skip)
    elif meta.bun_closest > 1 and skip is None:
        raise _no_bundle_engine("bun_closest")
    else:
        COUNTS["closest_slot"] += 1
        budget = dict(mult=meta.slot_mult_tight, mult_wide=meta.slot_mult,
                      skip=skip)
        if ch.n_treelets >= ts.CROSS_2L_MIN_CHUNKS:
            lists, ov = candidate_lists_fused(ch, o, d, t_max, ts.C_MAIN)
            t, prim, ov, ok = ts.stream_closest_l(
                ch, lists, ov, o, d, t_max, C=ts.C_MAIN, **budget)
        else:
            t, prim, ov, ok = ts.stream_closest_w(
                ch, ts.cross_words(ch, o, d, t_max), o, d, t_max,
                C=ts.C_MAIN, **budget)
    if ok:
        idx, n_ov = _compact_indices(ov)
        COUNTS["overflow_rays"] += n_ov
        if n_ov > ts.OV_CAP:
            ok = False
        elif n_ov:
            # The compacted lanes are all live: yuki_tpu's dead tail of
            # the static cap (skip -2, t_max 0) is not built.
            COUNTS["wide_reruns"] += 1
            t_w, p_w, _, _, ov2, ok2 = ts.stream_closest(
                ch, scene.tris.shading_packed, o[idx], d[idx], t_max[idx],
                C=ts.C_WIDE, mult=(ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT),
                mult_wide=ts.C_WIDE, budget_n=_wide_cap(n_ov),
                skip=None if skip is None else skip[idx])
            t[idx] = t_w
            prim[idx] = p_w
            ok = ok2 and not ts.host_int(ov2.any())
    if not ok:
        COUNTS["fallbacks"] += 1
        t, prim, b0, b1 = treelet_closest(tl, o, d, t_max)
        if skip is not None:
            # The walk has no skip: shadow lanes read only .hit, from the
            # occlusion walk that has one.
            occ = treelet_any(tl, o, d, t_max, skip)
            prim = torch.where(skip != -2, occ.to(torch.int32) - 1, prim)
        return t, prim, b0, b1
    nb = o.shape[0] if n_bary is None else n_bary
    b0, b1 = ts._recompute_bary(scene.tris.shading_packed, o[:nb], d[:nb],
                                t[:nb], prim[:nb])
    if nb < o.shape[0]:
        pad = t.new_zeros(o.shape[0] - nb)
        b0, b1 = torch.cat([b0, pad]), torch.cat([b1, pad])
    return t, prim, b0, b1


def _any_dispatch(scene, meta, o, d, t_max, skip):
    """Triangle occlusion by the adaptive dispatch over padded rays."""
    ch, tl = scene.chunks, scene.treelets
    row_words = row_words_interval(ch, o, d, t_max)
    if _coherent(row_words):
        COUNTS["any_rows"] += 1
        occ, ov = rows_any_w(ch, row_words, o, d, t_max, skip, C=_ROWS_C,
                             mult=_ROWS_MULT)
        ok = True
    elif WALKER_ANY:
        COUNTS["any_walker"] += 1
        occ, ov, ok = walker_any_w(
            ch, ts.cross_words(ch, o, d, t_max), o, d, t_max, skip,
            mult=WALKER_MULT_ANY[0], mult_wide=WALKER_MULT_ANY[1])
    elif meta.bun_any > 1:
        raise _no_bundle_engine("bun_any")
    else:
        COUNTS["any_slot"] += 1
        budget = dict(mult=max(3, meta.slot_mult_tight - 1),
                      mult_wide=max(4, meta.slot_mult - 2))
        if ch.n_treelets >= ts.CROSS_2L_MIN_CHUNKS:
            lists, ov = candidate_lists_fused(ch, o, d, t_max, ts.C_MAIN)
            occ, ov, ok = ts.stream_any_l(ch, lists, ov, o, d, t_max, skip,
                                          C=ts.C_MAIN, **budget)
        else:
            occ, ov, ok = ts.stream_any_w(
                ch, ts.cross_words(ch, o, d, t_max), o, d, t_max, skip,
                C=ts.C_MAIN, **budget)
    if ok:
        # An occluded verdict is final even from a cut list: only the
        # unoccluded overflow rays re-run (traverse.py:771-777).
        idx, n_ov = _compact_indices(ov & ~occ)
        COUNTS["overflow_rays"] += n_ov
        if n_ov > ts.OV_CAP:
            ok = False
        elif n_ov:
            COUNTS["wide_reruns"] += 1
            occ_w, ov2, ok2 = ts.stream_any(
                ch, o[idx], d[idx], t_max[idx], skip[idx], C=ts.C_WIDE,
                mult=(ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT),
                mult_wide=ts.C_WIDE, budget_n=_wide_cap(n_ov))
            occ[idx] = occ_w
            ok = ok2 and not ts.host_int((ov2 & ~occ_w).any())
    if not ok:
        COUNTS["fallbacks"] += 1
        return treelet_any(tl, o, d, t_max, skip)
    return occ


def intersect(scene, meta, o, d, t_max, skip_light=None, skip_sort=False,
              bary_count=None) -> SceneHit:
    """Full scene closest hit: the dense sweep or the treelet dispatch,
    then the spheres.

    ``skip_light`` [N] i32 (or None): each lane ignores the triangles of
    that area light; -2 matches none (combined closest + shadow waves).
    ``skip_sort``: call the dispatch on the rays' natural order instead of
    sorting them by ``ray_sort_key`` (yuki_tpu's default, False, sorts).
    ``bary_count`` (with ``skip_sort`` only, as in yuki_tpu): barycentrics
    only for the first bary_count lanes rounded up to 128, zeros past them
    unless the wave fell back to the treelet walk."""
    if meta.traversal == "dense":
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
                skip=None if sk is None else padded[3], n_bary=nb))

        t, prim, b0, b1 = _sorted_call(scene, o, d, t_max, skip_light, run,
                                       skip_sort)
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
                scene, o, d, t_max, sk))[:n0],)

        (occ,) = _sorted_call(scene, o, d, t_max, skip_light, run, skip_sort)
    return occ | ray_spheres(o, d, t_max, scene.spheres).hit
