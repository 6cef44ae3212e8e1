"""Scene queries for the path integrator: port of ``yuki_tpu/traverse.py``'s
``SceneHit``, ``intersect`` and ``any_intersect`` for treelet scenes.

Treelet-scene queries go through ``yuki_tpu``'s adaptive dispatch
(traverse.py:445-646 and :689-844), with rays in their natural order
(``path_li`` calls with ``skip_sort=True``; the coherence sort is not
ported):

1. The batch is padded to a multiple of 128 with parked rays (``_pad128``).
2. The interval probe (``ops/trace_rows.row_words_interval``) gives each
   128-ray row's conservative chunk demand (``_rows_demand``).  A wave
   within the rows engine's capacity is coherent.  The row-union kernels
   are not ported yet: a coherent wave takes the exact two-level treelet
   walk (``ops/trace_treelets.py``), which is yuki_tpu's own fallback
   engine.
3. A divergent wave takes the slot stream (``ops/trace_stream.py``): per-ray
   candidate lists from the two-level cull (``ops/trace_cull.py``) from
   CROSS_2L_MIN_CHUNKS chunks up, else from crossing words; the slot walk;
   the per-ray merge.
4. Rays whose list was cut at C_MAIN re-run through the wide pass at
   C_WIDE (occlusion: only those not yet occluded, since occlusion is
   monotone in the candidate set), with the slot budget of the overflow
   tier their count selects.
5. A blown budget (slot demand, more than OV_CAP overflow rays, or a wide
   re-run that overflows again) sends the whole wave to the treelet walk.
6. Closest hits get their barycentrics from the winning triangle
   (``_recompute_bary``).

Every engine is exact, so the branches agree on prim and occlusion; the
slot stream's t is one IEEE divide of a scaled hit, the walk's a multiply
by a reciprocal, so t may differ by an ulp between them.  ``COUNTS``
records calls per branch, overflow rays, wide re-runs, fallbacks and host
reads (``counts()``).

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
from .ops import trace_stream as ts
from .ops.trace import F32_MAX
from .ops.trace_cull import candidate_lists_fused
from .ops.trace_rows import row_words_interval
from .ops.trace_treelets import treelet_any, treelet_closest

__all__ = ["F32_MAX", "SceneHit", "any_intersect", "counts", "intersect",
           "reset_counts"]

# Rows-engine capacity of the dispatch probe (traverse.py:319-320).
_ROWS_C = 160
_ROWS_MULT = 24
_ROWS_QUAD = 4  # yuki_tpu/ops/trace_rows.py QUAD

COUNTS = {
    "closest_slot": 0, "closest_coherent_walk": 0,
    "any_slot": 0, "any_coherent_walk": 0,
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


def _require_treelet(meta) -> None:
    if meta.traversal != "treelet":
        raise NotImplementedError(
            f"scene queries for traversal {meta.traversal!r} need the dense "
            "trace kernels (ops/trace.py _dense_kernel/_any_kernel), not "
            "ported yet (ROADMAP Queue 2 item 3)"
        )


def _rows_demand(row_words):
    """The rows engine's pair demand (traverse.py:323-339): per row the
    popcount clamped to [1, _ROWS_C], aligned to QUAD, summed."""
    pc = ts.popcount32(row_words).sum(dim=-1)
    pc = torch.clamp(pc, 1, _ROWS_C)
    return (-(-pc // _ROWS_QUAD) * _ROWS_QUAD).sum()


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


def _coherent(ch, o, d, t_max) -> bool:
    rows = o.shape[0] // ts.LANES
    demand = _rows_demand(row_words_interval(ch, o, d, t_max))
    return ts.host_int(demand) <= rows * _ROWS_MULT


def _wide_cap(n_ov: int) -> int:
    """The overflow tier that holds n_ov rays (traverse.py:576-591)."""
    for cap in (ts.OV_SMALL, ts.OV_MID):
        if n_ov <= cap:
            return cap
    return ts.OV_CAP


def _closest_dispatch(scene, meta, o, d, t_max):
    """Triangle closest hit by the adaptive dispatch over padded rays."""
    ch, tl = scene.chunks, scene.treelets
    if _coherent(ch, o, d, t_max):
        COUNTS["closest_coherent_walk"] += 1
        return treelet_closest(tl, o, d, t_max)
    COUNTS["closest_slot"] += 1
    budget = dict(mult=meta.slot_mult_tight, mult_wide=meta.slot_mult)
    if ch.n_treelets >= ts.CROSS_2L_MIN_CHUNKS:
        lists, ov = candidate_lists_fused(ch, o, d, t_max, ts.C_MAIN)
        t, prim, ov, ok = ts.stream_closest_l(ch, lists, ov, o, d, t_max,
                                              C=ts.C_MAIN, **budget)
    else:
        t, prim, ov, ok = ts.stream_closest_w(
            ch, ts.cross_words(ch, o, d, t_max), o, d, t_max, C=ts.C_MAIN,
            **budget)
    if ok:
        idx, n_ov = _compact_indices(ov)
        COUNTS["overflow_rays"] += n_ov
        if n_ov > ts.OV_CAP:
            ok = False
        elif n_ov:
            COUNTS["wide_reruns"] += 1
            t_w, p_w, _, _, ov2, ok2 = ts.stream_closest(
                ch, scene.tris.shading_packed, o[idx], d[idx], t_max[idx],
                C=ts.C_WIDE, mult=(ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT),
                mult_wide=ts.C_WIDE, budget_n=_wide_cap(n_ov))
            t[idx] = t_w
            prim[idx] = p_w
            ok = ok2 and not ts.host_int(ov2.any())
    if not ok:
        COUNTS["fallbacks"] += 1
        return treelet_closest(tl, o, d, t_max)
    b0, b1 = ts._recompute_bary(scene.tris.shading_packed, o, d, t, prim)
    return t, prim, b0, b1


def _any_dispatch(scene, meta, o, d, t_max, skip):
    """Triangle occlusion by the adaptive dispatch over padded rays."""
    ch, tl = scene.chunks, scene.treelets
    if _coherent(ch, o, d, t_max):
        COUNTS["any_coherent_walk"] += 1
        return treelet_any(tl, o, d, t_max, skip)
    COUNTS["any_slot"] += 1
    budget = dict(mult=max(3, meta.slot_mult_tight - 1),
                  mult_wide=max(4, meta.slot_mult - 2))
    if ch.n_treelets >= ts.CROSS_2L_MIN_CHUNKS:
        lists, ov = candidate_lists_fused(ch, o, d, t_max, ts.C_MAIN)
        occ, ov, ok = ts.stream_any_l(ch, lists, ov, o, d, t_max, skip,
                                      C=ts.C_MAIN, **budget)
    else:
        occ, ov, ok = ts.stream_any_w(ch, ts.cross_words(ch, o, d, t_max),
                                      o, d, t_max, skip, C=ts.C_MAIN,
                                      **budget)
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


def intersect(scene, meta, o, d, t_max) -> SceneHit:
    """Full scene closest hit: the treelet dispatch, then the spheres."""
    _require_treelet(meta)
    n = o.shape[0]
    t, prim, b0, b1 = (x[:n] for x in _closest_dispatch(
        scene, meta, *_pad128(scene, o, d, t_max)))
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
    n = o.shape[0]
    occ = _any_dispatch(scene, meta,
                        *_pad128(scene, o, d, t_max, skip_light))[:n]
    return occ | ray_spheres(o, d, t_max, scene.spheres).hit
