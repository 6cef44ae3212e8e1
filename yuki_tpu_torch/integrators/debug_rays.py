"""Debug-ray collection: port of ``yuki_tpu/integrators/debug_rays.py``,
the reference's ``li_debug`` path (integrators/mod.rs:104-117,
path.rs:58-96, window.rs:811-905).

Re-traces the path for a handful of film pixels and records every ray
segment with its type, so a front end can overlay them on the image; the
reference draws them as GL lines coloured Direct/Reflection/Refraction/
Normal/Shadow -> white/red/green/blue/yellow
(renderpasses/ray_visualization.rs:33-66).

Segment lengths follow the reference: hit rays end at t; miss and normal
segments are min_debug_ray_length = the scene bounds' largest extent / 10
long (path.rs:58-64); shadow rays run to 0.9999 of the way to the sampled
light point.  The walks are host loops over tiny batches: each bounce (or
Whitted tree level) is one batched query through ``traverse`` and the
shading chain on the scene's device, read back once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import bsdf as bsdf_mod
from .. import lights as lights_mod
from .. import traverse
from ..sampling import SampleCtx
from ..scene.data import MAT_GLASS
from ..surface import make_surface, spawn_ray, spawn_ray_to
from ..vecmath import is_black

RAY_COLORS = {
    "direct": (1.0, 1.0, 1.0),
    "reflection": (1.0, 0.0, 0.0),
    "refraction": (0.0, 1.0, 0.0),
    "normal": (0.0, 0.0, 1.0),
    "shadow": (1.0, 1.0, 0.0),
}


@dataclass
class DebugRay:
    o: np.ndarray  # [3]
    end: np.ndarray  # [3]
    ray_type: str


def _host(*tensors):
    return [t.cpu().numpy() for t in tensors]


def _min_len(data) -> float:
    lo, hi = _host(data.world_lo, data.world_hi)
    return float((hi - lo).max()) / 10.0


def _closest(data, meta, o, d):
    t_max = torch.full(o.shape[:1], traverse.F32_MAX, dtype=torch.float32,
                       device=o.device)
    hit = traverse.intersect(data, meta, o, d, t_max)
    return hit, make_surface(data, hit, o, d)


def collect_debug_rays(data, meta, params, sampler, ctx: SampleCtx, o,
                       d) -> List[List[DebugRay]]:
    """The path integrator's walk for a small batch of rays o, d [n, 3]
    (``data``: the SceneData): per lane, its segments in order (each
    bounce's ray, the hit's normal, one shadow ray a light where the light
    sample is not black), bounce after bounce while the BSDF sample is
    valid, for ``params.max_depth`` bounces.  Sampler dimensions as
    path_li's: 2 a light, 2 for the BSDF sample and 1 for roulette, from
    dimension 2."""
    n = o.shape[0]
    out: List[List[DebugRay]] = [[] for _ in range(n)]
    min_len = _min_len(data)
    alive = np.ones(n, dtype=bool)
    ray_type = ["direct"] * n
    dim = 2
    for _bounce in range(params.max_depth):
        hit, si = _closest(data, meta, o, d)
        mp = bsdf_mod.gather_materials(data, si)
        o_np, d_np, t_np, hit_np, p_np, n_np = _host(o, d, hit.t, hit.hit,
                                                     si.p, si.n)
        for i in range(n):
            if not alive[i]:
                continue
            seg_len = t_np[i] if hit_np[i] else min_len
            out[i].append(DebugRay(o_np[i], o_np[i] + d_np[i] * seg_len,
                                   ray_type[i]))
            if hit_np[i]:
                out[i].append(DebugRay(p_np[i], p_np[i] + n_np[i] * min_len,
                                       "normal"))

        # NEE shadow rays, one a light (the fold in path.rs:102-124).
        for li_idx, ltype in enumerate(meta.light_types):
            u = sampler.get_2d(ctx, dim)
            dim += 2
            ls = lights_mod.sample_li(data, li_idx, ltype, si, u)
            o_s, d_s = spawn_ray_to(si, ls.target)
            worth, o_s_np, d_s_np = _host(~is_black(ls.li), o_s, d_s)
            for i in range(n):
                if alive[i] and hit_np[i] and worth[i]:
                    out[i].append(DebugRay(
                        o_s_np[i], o_s_np[i] + d_s_np[i] * 0.9999, "shadow"))

        u2 = sampler.get_2d(ctx, dim)
        dim += 3  # bsdf 2 + the roulette slot (path_li's layout)
        bs = bsdf_mod.bsdf_sample(mp, si, si.wo, u2)
        valid, trans = _host(bs.valid, bs.is_transmission)
        alive = alive & hit_np & valid
        for i in range(n):
            if alive[i]:
                ray_type[i] = "refraction" if trans[i] else "reflection"
        o = spawn_ray(si, bs.wi)
        d = bs.wi
        if not alive.any():
            break
    return out


def collect_debug_rays_whitted(data, meta, params, sampler, ctx: SampleCtx,
                               o, d) -> List[List[DebugRay]]:
    """Whitted's li_debug walk (whitted.rs:73-181): the Whitted tree is
    deterministic and branching, so every glass hit spawns a reflection
    (red) and a refraction (green) child and both subtrees are collected.
    Level by level: all nodes of one tree depth trace in one query, their
    NEE draws keyed by the lane each node came from."""
    n = o.shape[0]
    out: List[List[DebugRay]] = [[] for _ in range(n)]
    min_len = _min_len(data)
    o_np, d_np = _host(o, d)
    # The work items of the current tree depth: (lane, o [3], d [3], type).
    level = [(i, o_np[i], d_np[i], "direct") for i in range(n)]
    dev = o.device
    dim = 2
    for depth in range(params.max_depth):
        if not level:
            break
        o_b = torch.as_tensor(np.stack([w[1] for w in level]), device=dev)
        d_b = torch.as_tensor(np.stack([w[2] for w in level]), device=dev)
        hit, si = _closest(data, meta, o_b, d_b)
        mp = bsdf_mod.gather_materials(data, si, meta)
        t_np, hit_np, p_np, n_np = _host(hit.t, hit.hit, si.p, si.n)
        for k, (lane, wo, wd, rtype) in enumerate(level):
            seg = t_np[k] if hit_np[k] else min_len
            out[lane].append(DebugRay(wo, wo + wd * seg, rtype))
            if hit_np[k]:
                out[lane].append(DebugRay(p_np[k], p_np[k] + n_np[k] * min_len,
                                          "normal"))

        # NEE shadow rays a light (whitted.rs:119-141), the sample context
        # re-indexed by each node's lane.
        lanes = torch.as_tensor([w[0] for w in level], dtype=torch.int64,
                                device=ctx.px.device)
        ctx_l = SampleCtx(px=ctx.px[lanes], py=ctx.py[lanes],
                          sample_index=ctx.sample_index, seed=ctx.seed)
        for li_idx, ltype in enumerate(meta.light_types):
            u = sampler.get_2d(ctx_l, dim)
            dim += 2
            ls = lights_mod.sample_li(data, li_idx, ltype, si, u)
            o_s, d_s = spawn_ray_to(si, ls.target)
            worth, o_s_np, d_s_np = _host(~is_black(ls.li), o_s, d_s)
            for k, (lane, *_rest) in enumerate(level):
                if hit_np[k] and worth[k]:
                    out[lane].append(DebugRay(
                        o_s_np[k], o_s_np[k] + d_s_np[k] * 0.9999, "shadow"))

        if depth + 1 >= params.max_depth:
            break
        # Both specular children (glass only); nothing is sampled.
        nxt = []
        for transmission, rtype in ((False, "reflection"),
                                    (True, "refraction")):
            bs = bsdf_mod.bsdf_sample_specular(mp, si, si.wo, transmission)
            valid, o_c, d_c = _host(bs.valid, spawn_ray(si, bs.wi), bs.wi)
            for k, (lane, *_rest) in enumerate(level):
                if hit_np[k] and valid[k]:
                    nxt.append((lane, o_c[k], d_c[k], rtype))
        level = nxt
    return out


def project_segments(camera, res_x: int, res_y: int, rays: List[DebugRay]):
    """World-space segments -> raster space for 2D overlays (the GL line
    pass, renderpasses/ray_visualization.rs).  Returns a list of dicts
    {x0, y0, x1, y1, type, color}; a segment with an end behind the
    camera is dropped."""
    w2c = np.linalg.inv(np.asarray(camera.camera_to_world, dtype=np.float64))
    c2r_full = np.linalg.inv(np.asarray(camera.raster_to_camera,
                                        dtype=np.float64))

    def raster_of(p_world):
        pc = w2c[:3, :3] @ p_world + w2c[:3, 3]
        if pc[2] <= 1e-6:
            return None
        h = c2r_full @ np.append(pc, 1.0)
        if abs(h[3]) < 1e-12:
            return None
        return (h[0] / h[3], h[1] / h[3])

    out = []
    for r in rays:
        a = raster_of(np.asarray(r.o, dtype=np.float64))
        b = raster_of(np.asarray(r.end, dtype=np.float64))
        if a is None or b is None:
            continue
        out.append({"x0": a[0], "y0": a[1], "x1": b[0], "y1": b[1],
                    "type": r.ray_type, "color": RAY_COLORS[r.ray_type]})
    return out
