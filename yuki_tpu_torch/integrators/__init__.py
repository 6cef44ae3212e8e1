"""Wavefront integrators: port of ``yuki_tpu/integrators/__init__.py``.

The reference's recursive per-ray integrators (yuki/src/integrators/)
become masked wavefront passes: the whole pixel batch marches through
trace -> shade -> next ray together, dead lanes masked out and parked at
the scene centre on a zero-length ray.  Registry (IntegratorType,
integrators/mod.rs:32-53):

  ``path_li``     Path: NEE every bounce, optional indirect clamp, Russian
                  roulette after bounce 3 (:190-392).  Where the fused
                  shade gate holds (``use_fused_shade``), each bounce is a
                  closest-hit query, the shade kernel, one light-major
                  occlusion query and the resolve kernel (:234-314);
                  elsewhere (a lightless scene, a textured sphere, or
                  ``FUSED_SHADE_MODE = "off"``) the shading chain
                  (:316-377): ``surface.make_surface``,
                  ``bsdf.gather_materials``, ``_nee`` (``lights.sample_li``,
                  ``bsdf.bsdf_f``, one batched occlusion query),
                  ``lights.area_light_radiance``, ``bsdf.bsdf_sample``.
  ``whitted_li``  Whitted: direct lighting plus perfect specular
                  reflection and transmission (:395-568), the recursion
                  walked as a per-lane depth-first stack.
  ``geometry_normals_li``, ``shading_normals_li``, ``shading_uvs_li``,
  ``bvh_intersections_li``  the debug views (:571-611); the last reads the
                  threaded BVH walk's node steps.

Sampler dimensions: camera jitter takes 0-1; Path takes 2L+3 a bounce (2
a light, 2 for the BSDF sample, 1 for roulette, reserved on every
bounce), Whitted 2L a tree step.  Whitted and the debug views call the
scene queries without ``skip_sort``, so treelet scenes take the coherence
sort there, as in yuki_tpu.  Loops that end on the data (Whitted's tree,
the BVH walk) read one flag on the host a step, as yuki_tpu's
``while_loop`` conds read ``jnp.any``; ``COUNTS`` counts Whitted's steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .. import bsdf as bsdf_mod
from .. import lights as lights_mod
from .. import traverse
from ..ops import trace_stream as ts
from ..ops._build import bump
from ..profiling import host_read, pass_scope
from ..scene.data import MAT_GLASS
from ..surface import Surface, make_surface, spawn_ray, spawn_ray_to
from ..vecmath import const, dot, is_black


@dataclass(frozen=True)
class WhittedParams:
    max_depth: int = 3


@dataclass(frozen=True)
class PathParams:
    max_depth: int = 3
    indirect_clamp: Optional[float] = None


class LiResult(NamedTuple):
    li: torch.Tensor  # [N,3]
    ray_count: torch.Tensor  # [N] i32 closest-hit traversals (shadow rays
    # are traced, not counted: path.rs:97 / whitted.rs:117)


# path_li's shading route: "auto" takes the shade and resolve kernels
# wherever use_fused_shade's gate holds; "off" takes the shading chain on
# every scene.
FUSED_SHADE_MODE = "auto"

# Hard ceiling on Whitted's specular-tree steps (:75-80): 255 covers every
# full tree to depth 8 and every practical reflect / transmit chain above.
_MAX_SPECULAR_STEPS = 255

# Whitted's tree steps since reset_counts().
COUNTS = {"whitted_steps": 0}


def reset_counts() -> None:
    COUNTS["whitted_steps"] = 0


def _benign_d(like: torch.Tensor) -> torch.Tensor:
    """The unit direction +z of parked lanes (a zero direction's inverse
    would turn the slab tests into NaNs)."""
    return torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                        device=like.device)


def _center(data) -> torch.Tensor:
    return 0.5 * (data.world_lo + data.world_hi)


def use_fused_shade(meta, sampler) -> bool:
    """Whether path_li takes the shade and resolve kernels (:57-68): the
    scene has a light, the fused gate holds and FUSED_SHADE_MODE is
    "auto"."""
    from ..ops import shade_fused

    if FUSED_SHADE_MODE not in ("auto", "off"):
        raise ValueError(f"FUSED_SHADE_MODE {FUSED_SHADE_MODE!r}: 'auto' or "
                         "'off'")
    return (FUSED_SHADE_MODE == "auto" and len(meta.light_types) > 0
            and shade_fused.fused_shade_supported(meta, sampler))


def whitted_step_budget(depth_cap: int, has_glass: bool) -> int:
    """The bound on whitted_li's tree steps (:83-91): one for glass-free
    scenes (glass is the only dual-lobe material, whitted.rs:38-70), the
    full binary tree capped at _MAX_SPECULAR_STEPS otherwise."""
    if not has_glass:
        return 1
    return max(1, min(2 ** depth_cap - 1, _MAX_SPECULAR_STEPS))


def _host_any(mask: torch.Tensor) -> bool:
    """Whether any lane is set: one host read, counted in the dispatch's
    ``host_syncs`` and in ``host_reads.whitted``."""
    bump(ts.STATS, "host_syncs")
    return bool(host_read(mask.any(), "whitted"))


# --- next-event estimation (:100-187) --------------------------------------


def _nee_setup(data, meta, sampler, ctx, si: Surface, mp, dim: int, active):
    """Every light's NEE shadow ray and raw contribution, flattened
    light-major into one [L*N] batch: (o, d, t_max, skip, worth, contrib
    (f * li * cos / pdf, no beta), next dim).  Lanes whose contribution
    is zero (black f or li, the light behind the shading normal, dead
    lanes) trace a zero-length ray parked at the scene centre."""
    center = _center(data)
    benign = _benign_d(si.p)
    rays = []
    for li_idx, ltype in enumerate(meta.light_types):
        u = sampler.get_2d(ctx, dim)
        dim += 2
        ls = lights_mod.sample_li(data, li_idx, ltype, si, u)
        f = bsdf_mod.bsdf_f(mp, si, si.wo, ls.l, meta)
        cos = torch.clamp(dot(si.ns, ls.l), 0.0, 1.0)
        worth = active & ~is_black(ls.li) & ~is_black(f) & (cos > 0.0)
        o_s, d_s = spawn_ray_to(si, ls.target)
        w3 = worth[..., None]
        contrib = f * ls.li * (cos / torch.clamp(ls.pdf, min=1e-30))[..., None]
        rays.append((torch.where(w3, o_s, center), torch.where(w3, d_s, benign),
                     torch.where(worth, 0.9999, 0.0).to(torch.float32),
                     ls.skip_light.expand(worth.shape), worth, contrib))
    cat = lambda i: torch.cat([r[i] for r in rays])
    return tuple(cat(i) for i in range(6)) + (dim,)


def _nee_resolve(occ_b, worth_b, contrib_b, n: int, n_lights: int):
    """Occlusion verdicts -> direct lighting [n, 3], summed over the
    lights in order."""
    lit = torch.where((worth_b & ~occ_b)[..., None], contrib_b, 0.0)
    total = lit[:n]
    for li in range(1, n_lights):
        total = total + lit[li * n:(li + 1) * n]
    return total


def _nee(data, meta, sampler, ctx, si: Surface, mp, dim: int, active,
         skip_sort: bool = False):
    """Direct lighting summed over every light (path.rs:102-124,
    whitted.rs:119-141): _nee_setup, one batched occlusion query,
    _nee_resolve.  Returns (radiance [N,3], next dim)."""
    n_lights = len(meta.light_types)
    if n_lights == 0:
        return torch.zeros_like(si.p), dim
    o_b, d_b, t_b, s_b, w_b, c_b, dim = _nee_setup(data, meta, sampler, ctx,
                                                   si, mp, dim, active)
    with pass_scope("trace.occlusion"):
        occ_b = traverse.any_intersect(data, meta, o_b, d_b, t_b, s_b,
                                       skip_sort=skip_sort)
    return _nee_resolve(occ_b, w_b, c_b, si.p.shape[0], n_lights), dim


# --- Path --------------------------------------------------------------------


def _ph_i32(ctx) -> torch.Tensor:
    """pcg(pixel_hash ^ sample_index) per lane, as int32 bits."""
    from ..sampling import _u32, pcg_hash

    ph = ctx.pixel_hash()
    u = pcg_hash(ph ^ _u32(ctx.sample_index, ph.device))
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def _path_fused(scene, meta, params, sampler, ctx, o, d, tables, dim):
    """path_li's fused-shade branch (:234-314)."""
    from ..ops import shade_fused
    from ..ops.path_fused import bounce_draws
    from ..sampling import StratifiedSampler

    data = scene.data
    if tables is None:
        tables = shade_fused.make_shade_tables(scene, params)
    n_lights = len(meta.light_types)
    dims_per_bounce = 2 * n_lights + 2 + 1
    n, dev = o.shape[0], o.device
    ph = _ph_i32(ctx)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_count = torch.zeros(n, dtype=torch.int32, device=dev)
    strat = isinstance(sampler, StratifiedSampler)
    for bounce in range(params.max_depth):
        dim0 = dim + bounce * dims_per_bounce
        spl = (torch.stack(bounce_draws(sampler, ctx, dim0, n_lights))
               if strat else None)
        ray_count = ray_count + alive.to(torch.int32)
        t_max = torch.where(alive, traverse.F32_MAX, 0.0).to(torch.float32)
        with pass_scope("trace.closest"):
            hit = traverse.intersect(data, meta, o, d, t_max,
                                     skip_sort=True)
        missed = alive & ~hit.hit
        alive = alive & hit.hit
        with pass_scope("shade.fused"):
            (o2, d2, beta2, alive2, spec2, no, nd, nt, ns_skip, nw, nc,
             ne) = shade_fused.shade_fused(tables, hit, o, d, beta, alive,
                                           specular_bounce, ph, dim0,
                                           bounce, spl)
        with pass_scope("trace.occlusion"):
            occ = traverse.any_intersect(data, meta, no, nd, nt, ns_skip,
                                         skip_sort=True)
        with pass_scope("shade.resolve"):
            radiance = shade_fused.resolve_fused(tables, radiance, beta,
                                                 alive, missed, ne, occ, nw,
                                                 nc, bounce)
        o, d, beta, alive, specular_bounce = o2, d2, beta2, alive2, spec2
    return LiResult(li=radiance, ray_count=ray_count)


def _path_chain(scene, meta, params, sampler, ctx, o, d, dim):
    """path_li's shading chain (:316-377)."""
    data = scene.data
    n_lights = len(meta.light_types)
    dims_per_bounce = 2 * n_lights + 2 + 1
    n, dev = o.shape[0], o.device
    center, benign = _center(data), _benign_d(o)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
    ray_count = torch.zeros(n, dtype=torch.int32, device=dev)
    for bounce in range(params.max_depth):
        dim0 = dim + bounce * dims_per_bounce
        ray_count = ray_count + alive.to(torch.int32)
        t_max = torch.where(alive, traverse.F32_MAX, 0.0).to(torch.float32)
        with pass_scope("trace.closest"):
            hit = traverse.intersect(data, meta, o, d, t_max,
                                     skip_sort=True)
        # A miss adds the background and ends the path (path.rs:155-160).
        missed = alive & ~hit.hit
        radiance = radiance + torch.where(missed[..., None],
                                          beta * data.background, 0.0)
        alive = alive & hit.hit
        with pass_scope("shade.surface"):
            si = make_surface(data, hit, o, d)
            mp = bsdf_mod.gather_materials(data, si, meta)
        with pass_scope("shade.nee"):
            bounce_radiance, dimn = _nee(data, meta, sampler, ctx, si, mp,
                                         dim0, alive, skip_sort=True)
        # Emission on the first and specular hits.  The reference weighs
        # the emitted term by beta here AND the whole bounce's radiance
        # by beta below (path.rs:126-137); kept for image parity.
        emitted = lights_mod.area_light_radiance(data, si, -d)
        emit_mask = specular_bounce | (bounce == 0)
        bounce_radiance = bounce_radiance + torch.where(
            emit_mask[..., None], beta * emitted, 0.0)
        if params.indirect_clamp is not None and bounce > 0:
            bounce_radiance = torch.clamp(bounce_radiance,
                                          max=params.indirect_clamp)
        radiance = radiance + torch.where(alive[..., None],
                                          beta * bounce_radiance, 0.0)

        u = sampler.get_2d(ctx, dimn)
        dimn += 2
        with pass_scope("shade.bsdf_sample"):
            bs = bsdf_mod.bsdf_sample(mp, si, si.wo, u, meta)
        alive = alive & ~(is_black(bs.f) | (bs.pdf == 0.0))
        specular_bounce = bs.is_specular
        beta = beta * bs.f * (torch.abs(dot(bs.wi, si.ns))
                              / torch.clamp(bs.pdf, min=1e-30))[..., None]
        # A non-finite throughput (a grazing microfacet pdf underflowing)
        # retires the lane instead of turning inf * 0 into NaN later.
        finite = torch.all(torch.isfinite(beta), dim=-1)
        alive = alive & finite
        beta = torch.where(finite[..., None], beta, 0.0)
        a3 = alive[..., None]
        o = torch.where(a3, spawn_ray(si, bs.wi), center)
        d = torch.where(a3, bs.wi, benign)

        # Russian roulette after bounce 3 (path.rs:162-169).
        if bounce > 3:
            q = torch.clamp(1.0 - beta[..., 1], min=0.05)
            alive = alive & ~(sampler.get_1d(ctx, dimn) < q)
            beta = beta / torch.clamp(1.0 - q, min=1e-30)[..., None]
    return LiResult(li=radiance, ray_count=ray_count)


def path_li(scene, meta, params: PathParams, sampler, ctx, o, d,
            tables=None, dim: int = 2) -> LiResult:
    """Path tracing with NEE every bounce, optional indirect clamp and
    Russian roulette after bounce 3 (path.rs:48-178), on dense and treelet
    scenes; every query passes ``skip_sort=True``, as yuki_tpu's path_li
    does.  ``scene``: the Scene.  ``tables``: the fused route's
    ``shade_fused.make_shade_tables(scene, params)``, built here when
    None."""
    if use_fused_shade(meta, sampler):
        return _path_fused(scene, meta, params, sampler, ctx, o, d, tables,
                           dim)
    return _path_chain(scene, meta, params, sampler, ctx, o, d, dim)


# --- Whitted (:395-568) --------------------------------------------------------


def _push(stack, sp, item, mask):
    """Write ``item`` at each lane's stack pointer where ``mask`` (a
    scatter that leaves the other lanes' entries as they were), then
    advance the pointer there."""
    size, n = stack["depth"].shape
    put = mask & (sp < size)
    at = torch.clamp(sp, max=size - 1).to(torch.int64)
    for k, v in item.items():
        buf = stack[k]
        idx = at.view(1, n, *([1] * (v.ndim - 1))).expand(1, *v.shape)
        keep = buf.gather(0, idx)[0]
        p = put.view(n, *([1] * (v.ndim - 1)))
        buf.scatter_(0, idx, torch.where(p, v, keep)[None])
    return sp + mask.to(torch.int32)


def _pop(stack, sp, mask):
    """Each lane's entry at sp - 1 (at 0 for an empty stack), and the
    pointer moved back where ``mask``."""
    n = sp.shape[0]
    at = torch.clamp(sp - 1, min=0).to(torch.int64)
    item = {}
    for k, buf in stack.items():
        idx = at.view(1, n, *([1] * (buf.ndim - 2))).expand(1, *buf.shape[1:])
        item[k] = buf.gather(0, idx)[0]
    return item, sp - mask.to(torch.int32)


def whitted_li(scene, meta, params: WhittedParams, sampler, ctx, o, d,
               dim: int = 2) -> LiResult:
    """Whitted: direct lighting plus recursive perfect specular
    reflection and transmission (whitted.rs:73-181).

    The recursion tree is walked iteratively: each step traces and shades
    one node a lane; a lane carries an explicit depth-first stack of
    pending transmission children (o, d, throughput scale, depth,
    specular flag), ``max_depth`` entries deep.  A reflection child goes
    on at once; a lane without one pops its stack, and a lane with
    neither is parked.  The loop ends when no lane is active and every
    stack is empty, or after ``whitted_step_budget`` steps.  NEE takes 2L
    sampler dimensions a step from ``dim``.  ``scene``: the Scene."""
    data = scene.data
    n, dev = o.shape[0], o.device
    depth_cap = params.max_depth
    n_steps = whitted_step_budget(depth_cap, MAT_GLASS in meta.material_types)
    size = max(depth_cap, 1)
    dims_per_step = 2 * len(meta.light_types)
    center, benign = _center(data), _benign_d(o)
    f32 = dict(dtype=torch.float32, device=dev)
    stack = {
        "o": torch.zeros((size, n, 3), **f32),
        "d": torch.zeros((size, n, 3), **f32),
        "scale": torch.zeros((size, n, 3), **f32),
        "depth": torch.zeros((size, n), dtype=torch.int32, device=dev),
        "spec": torch.zeros((size, n), dtype=torch.bool, device=dev),
    }
    radiance = torch.zeros((n, 3), **f32)
    ray_count = torch.zeros(n, dtype=torch.int32, device=dev)
    sp = torch.zeros(n, dtype=torch.int32, device=dev)
    cur_o, cur_d = o, d
    cur_scale = torch.ones((n, 3), **f32)
    cur_depth = torch.zeros(n, dtype=torch.int32, device=dev)
    cur_spec = torch.zeros(n, dtype=torch.bool, device=dev)
    cur_active = torch.ones(n, dtype=torch.bool, device=dev)
    step = 0
    while step < n_steps:
        with pass_scope("whitted.step"):
            if not _host_any(cur_active | (sp > 0)):
                break
            bump(COUNTS, "whitted_steps")
            dim0 = dim + step * dims_per_step
            ray_count = ray_count + cur_active.to(torch.int32)
            t_max = torch.where(cur_active, traverse.F32_MAX,
                                0.0).to(torch.float32)
            with pass_scope("trace.closest"):
                hit = traverse.intersect(data, meta, cur_o, cur_d, t_max)
            missed = cur_active & ~hit.hit
            radiance = radiance + torch.where(
                missed[..., None], cur_scale * data.background, 0.0)
            live = cur_active & hit.hit
            with pass_scope("shade.surface"):
                si = make_surface(data, hit, cur_o, cur_d)
                mp = bsdf_mod.gather_materials(data, si, meta)
            with pass_scope("shade.nee"):
                direct, _ = _nee(data, meta, sampler, ctx, si, mp, dim0,
                                 live)
            emit_mask = cur_spec | (cur_depth == 0)
            direct = direct + torch.where(
                emit_mask[..., None],
                lights_mod.area_light_radiance(data, si, -cur_d), 0.0)
            radiance = radiance + torch.where(live[..., None],
                                              cur_scale * direct, 0.0)

            # Specular children (whitted.rs:38-70), weighted f |wi . ns|.
            can_recurse = live & (cur_depth + 1 < depth_cap)
            bs_r = bsdf_mod.bsdf_sample_specular(mp, si, si.wo, False)
            bs_t = bsdf_mod.bsdf_sample_specular(mp, si, si.wo, True)

            def child(bs):
                scale = bs.f * torch.abs(dot(bs.wi, si.ns))[..., None]
                scale = torch.where(torch.isfinite(scale), scale,
                                    0.0) * cur_scale
                return {"o": spawn_ray(si, bs.wi), "d": bs.wi,
                        "scale": scale, "depth": cur_depth + 1,
                        "spec": bs.is_specular}

            r_valid = can_recurse & bs_r.valid
            sp = _push(stack, sp, child(bs_t), can_recurse & bs_t.valid)
            # Next: the reflection child where valid, else a pop, else
            # idle.
            popped = ~r_valid & (sp > 0)
            item, sp = _pop(stack, sp, popped)
            refl = child(bs_r)
            cur_active = r_valid | popped
            sel, act = r_valid[..., None], cur_active[..., None]
            cur_o = torch.where(act, torch.where(sel, refl["o"], item["o"]),
                                center)
            cur_d = torch.where(act, torch.where(sel, refl["d"], item["d"]),
                                benign)
            cur_scale = torch.where(sel, refl["scale"], item["scale"])
            cur_depth = torch.where(r_valid, refl["depth"], item["depth"])
            cur_spec = torch.where(r_valid, refl["spec"], item["spec"])
            step += 1
    return LiResult(li=radiance, ray_count=ray_count)


# --- debug views (:571-611) -----------------------------------------------------


def _closest(scene, meta, o, d, **kw):
    t_max = torch.full(o.shape[:-1], traverse.F32_MAX, dtype=torch.float32,
                       device=o.device)
    return traverse.intersect(scene.data, meta, o, d, t_max, **kw)


def _ones(o):
    return torch.ones(o.shape[:-1], dtype=torch.int32, device=o.device)


def _normal_view(scene, meta, o, d, field):
    hit = _closest(scene, meta, o, d)
    n = getattr(make_surface(scene.data, hit, o, d), field)
    col = torch.where(hit.hit[..., None], n / const(2.0, n) + 0.5, 0.0)
    return LiResult(li=col, ray_count=_ones(o))


def geometry_normals_li(scene, meta, o, d) -> LiResult:
    """The geometric normal, n / 2 + 0.5 (normals.rs)."""
    return _normal_view(scene, meta, o, d, "n")


def shading_normals_li(scene, meta, o, d) -> LiResult:
    """The shading normal, ns / 2 + 0.5."""
    return _normal_view(scene, meta, o, d, "ns")


def shading_uvs_li(scene, meta, o, d) -> LiResult:
    """The surface uv in red and green."""
    hit = _closest(scene, meta, o, d)
    uv = make_surface(scene.data, hit, o, d).uv
    col = torch.stack([uv[..., 0], uv[..., 1], torch.zeros_like(uv[..., 0])],
                      dim=-1)
    return LiResult(li=torch.where(hit.hit[..., None], col, 0.0),
                    ray_count=_ones(o))


def bvh_intersections_li(scene, meta, o, d) -> LiResult:
    """The traversal heatmap (bvh_heatmap.rs) from the threaded BVH walk:
    r = g = nodes visited (the stackless walk visits nodes rather than
    counting slab tests separately), b = the same where the ray hit."""
    hit, steps = _closest(scene, meta, o, d, with_stats=True)
    s = steps.to(torch.float32)
    return LiResult(li=torch.stack([s, s, torch.where(hit.hit, s, 0.0)],
                                   dim=-1), ray_count=_ones(o))


DEBUG_VIEWS = {
    "bvh_intersections": bvh_intersections_li,
    "geometry_normals": geometry_normals_li,
    "shading_normals": shading_normals_li,
    "shading_uvs": shading_uvs_li,
}
