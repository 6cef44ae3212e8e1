"""The reference renderer's integrators and its pixel loop.

``render_samples`` renders one sample of chosen pixels the way yuki
states a sample (integrators/mod.rs: camera jitter from sampler
dimensions 0-1, the integrator from dimension 2) and ``pixel_mean`` makes
a film value of a pixel's samples (summed in sample order, divided by the
sample count), with the plain Path and
Whitted integrators below: Path with next-event estimation every bounce
and Russian roulette after bounce 3 (path.rs), Whitted with direct light
and perfect specular children to its depth (whitted.rs), walked as a
per-lane depth-first stack.  A closest-hit ray is counted per lane as
yuki counts it; shadow rays are traced, not counted.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import intersect as isect
from .rmath import Lanes, Sampler, camera_rays, dot, is_black
from .shading import (MAT_GLASS, area_light_radiance, bsdf_f, bsdf_sample,
                      bsdf_sample_specular, gather_materials, make_surface,
                      sample_light, spawn_ray, spawn_ray_to)


@dataclass(frozen=True)
class Integrator:
    kind: str  # "path" or "whitted"
    max_depth: int


def _center(sc):
    return 0.5 * (sc.world_lo + sc.world_hi)


def _benign(like):
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)


def _direct(sc, sampler, lanes, si, mp, dim, active):
    """Every light's contribution with its shadow ray, summed over the
    lights in order; 2 sampler dimensions a light."""
    total = torch.zeros_like(si.p)
    center, benign = _center(sc), _benign(si.p)
    for k in range(len(sc.lights)):
        u = sampler.get_2d(lanes, dim)
        dim += 2
        ls = sample_light(sc, k, si, u)
        f = bsdf_f(mp, si, si.wo, ls.l)
        cos = torch.clamp(dot(si.ns, ls.l), 0.0, 1.0)
        worth = active & ~is_black(ls.li) & ~is_black(f) & (cos > 0.0)
        o_s, d_s = spawn_ray_to(si, ls.target)
        w3 = worth[..., None]
        contrib = f * ls.li * (cos / torch.clamp(ls.pdf, min=1e-30))[..., None]
        t_max = torch.where(worth, 0.9999, 0.0).to(si.p.dtype)
        occ = isect.occluded(sc, torch.where(w3, o_s, center),
                             torch.where(w3, d_s, benign), t_max,
                             ls.skip.expand(worth.shape))
        lit = torch.where((worth & ~occ)[..., None], contrib, 0.0)
        total = lit if k == 0 else total + lit
    return total, dim


def path_li(sc, sampler, lanes, o, d, max_depth: int, dim: int = 2):
    n, dev, dt = o.shape[0], o.device, o.dtype
    n_lights = len(sc.lights)
    per_bounce = 2 * n_lights + 3
    center, benign = _center(sc), _benign(o)
    beta = torch.ones((n, 3), dtype=dt, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    spec = torch.zeros(n, dtype=torch.bool, device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    inf = isect.big(dt)
    for bounce in range(max_depth):
        dim0 = dim + bounce * per_bounce
        rays = rays + alive.to(torch.int64)
        t_max = torch.where(alive, inf, 0.0).to(dt)
        hit = isect.closest(sc, o, d, t_max)
        missed = alive & ~hit.hit
        radiance = radiance + torch.where(missed[..., None],
                                          beta * sc.background, 0.0)
        alive = alive & hit.hit
        si = make_surface(sc, hit, o, d)
        mp = gather_materials(sc, si)
        if n_lights:
            bounce_rad, dimn = _direct(sc, sampler, lanes, si, mp, dim0, alive)
        else:
            bounce_rad, dimn = torch.zeros_like(si.p), dim0
        emitted = area_light_radiance(sc, si, -d)
        emit = spec | (bounce == 0)
        # yuki weighs the emitted term by beta here and the whole bounce's
        # radiance by beta again below (path.rs:126-137).
        bounce_rad = bounce_rad + torch.where(emit[..., None], beta * emitted,
                                              0.0)
        radiance = radiance + torch.where(alive[..., None], beta * bounce_rad,
                                          0.0)
        u = sampler.get_2d(lanes, dimn)
        dimn += 2
        bs = bsdf_sample(mp, si, si.wo, u)
        alive = alive & ~(is_black(bs.f) | (bs.pdf == 0.0))
        spec = bs.is_specular
        beta = beta * bs.f * (torch.abs(dot(bs.wi, si.ns))
                              / torch.clamp(bs.pdf, min=1e-30))[..., None]
        finite = torch.all(torch.isfinite(beta), dim=-1)
        alive = alive & finite
        beta = torch.where(finite[..., None], beta, 0.0)
        a3 = alive[..., None]
        o = torch.where(a3, spawn_ray(si, bs.wi), center)
        d = torch.where(a3, bs.wi, benign)
        if bounce > 3:
            q = torch.clamp(1.0 - beta[..., 1], min=0.05)
            alive = alive & ~(sampler.get_1d(lanes, dimn) < q)
            beta = beta / torch.clamp(1.0 - q, min=1e-30)[..., None]
    return radiance, rays


def whitted_li(sc, sampler, lanes, o, d, max_depth: int, dim: int = 2):
    n, dev, dt = o.shape[0], o.device, o.dtype
    has_glass = MAT_GLASS in sc.material_types
    n_steps = max(1, min(2 ** max_depth - 1, 255)) if has_glass else 1
    size = max(max_depth, 1)
    per_step = 2 * len(sc.lights)
    center, benign = _center(sc), _benign(o)
    inf = isect.big(dt)
    # The stack of pending transmission children: [size, n] per field.
    st_o = torch.zeros((size, n, 3), dtype=dt, device=dev)
    st_d = torch.zeros((size, n, 3), dtype=dt, device=dev)
    st_s = torch.zeros((size, n, 3), dtype=dt, device=dev)
    st_depth = torch.zeros((size, n), dtype=torch.int64, device=dev)
    st_spec = torch.zeros((size, n), dtype=torch.bool, device=dev)
    lane = torch.arange(n, device=dev)
    radiance = torch.zeros((n, 3), dtype=dt, device=dev)
    rays = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    cur_o, cur_d = o, d
    cur_s = torch.ones((n, 3), dtype=dt, device=dev)
    cur_depth = torch.zeros(n, dtype=torch.int64, device=dev)
    cur_spec = torch.zeros(n, dtype=torch.bool, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    step = 0
    while step < n_steps and bool((active | (sp > 0)).any()):
        dim0 = dim + step * per_step
        rays = rays + active.to(torch.int64)
        t_max = torch.where(active, inf, 0.0).to(dt)
        hit = isect.closest(sc, cur_o, cur_d, t_max)
        missed = active & ~hit.hit
        radiance = radiance + torch.where(missed[..., None],
                                          cur_s * sc.background, 0.0)
        live = active & hit.hit
        si = make_surface(sc, hit, cur_o, cur_d)
        mp = gather_materials(sc, si)
        if sc.lights:
            direct, _ = _direct(sc, sampler, lanes, si, mp, dim0, live)
        else:
            direct = torch.zeros_like(si.p)
        emit = cur_spec | (cur_depth == 0)
        direct = direct + torch.where(
            emit[..., None], area_light_radiance(sc, si, -cur_d), 0.0)
        radiance = radiance + torch.where(live[..., None], cur_s * direct, 0.0)

        recurse = live & (cur_depth + 1 < max_depth)
        bs_r = bsdf_sample_specular(mp, si, si.wo, False)
        bs_t = bsdf_sample_specular(mp, si, si.wo, True)

        def child(bs):
            s = bs.f * torch.abs(dot(bs.wi, si.ns))[..., None]
            s = torch.where(torch.isfinite(s), s, 0.0) * cur_s
            return spawn_ray(si, bs.wi), bs.wi, s, cur_depth + 1, bs.is_specular

        r_ok = recurse & bs_r.valid
        push = recurse & bs_t.valid
        # Push the transmission child where it exists.
        at = torch.clamp(sp, max=size - 1)
        put = push & (sp < size)
        t_o, t_d, t_s, t_depth, t_spec = child(bs_t)
        for buf, val in ((st_o, t_o), (st_d, t_d), (st_s, t_s),
                         (st_depth, t_depth), (st_spec, t_spec)):
            keep = buf[at, lane]
            mask = put.view(n, *([1] * (val.ndim - 1)))
            buf[at, lane] = torch.where(mask, val, keep)
        sp = sp + push.to(torch.int64)
        # Next: the reflection child, else a pop, else idle.
        popped = ~r_ok & (sp > 0)
        top = torch.clamp(sp - 1, min=0)
        p_o, p_d, p_s = st_o[top, lane], st_d[top, lane], st_s[top, lane]
        p_depth, p_spec = st_depth[top, lane], st_spec[top, lane]
        sp = sp - popped.to(torch.int64)
        r_o, r_d, r_s, r_depth, r_spec = child(bs_r)
        active = r_ok | popped
        sel, act = r_ok[..., None], active[..., None]
        cur_o = torch.where(act, torch.where(sel, r_o, p_o), center)
        cur_d = torch.where(act, torch.where(sel, r_d, p_d), benign)
        cur_s = torch.where(sel, r_s, p_s)
        cur_depth = torch.where(r_ok, r_depth, p_depth)
        cur_spec = torch.where(r_ok, r_spec, p_spec)
        step += 1
    return radiance, rays


def render_samples(sc, c2w, r2c, sampler: Sampler, integ: Integrator, px,
                   py, sample_index: int, seed: int, chunk: int = 1 << 15):
    """Sample ``sample_index`` of pixels px, py [P] (int64) with sampler
    seed ``seed``: (radiance [P,3] in the scene's dtype, closest-hit rays
    [P] int64)."""
    dt = sc.dtype
    c2w = torch.as_tensor(c2w, device=px.device).to(dt)
    r2c = torch.as_tensor(r2c, device=px.device).to(dt)
    li_fn = path_li if integ.kind == "path" else whitted_li
    out, counts = [], []
    for c0 in range(0, px.shape[0], chunk):
        cx, cy = px[c0:c0 + chunk], py[c0:c0 + chunk]
        lanes = Lanes(px=cx, py=cy, sample_index=sample_index, seed=seed)
        u = sampler.get_2d(lanes, 0)
        p_film = torch.stack([cx.to(dt), cy.to(dt)], dim=-1) + u
        o, d = camera_rays(c2w, r2c, p_film)
        li, r = li_fn(sc, sampler, lanes, o.contiguous(), d.contiguous(),
                      integ.max_depth)
        out.append(li)
        counts.append(r)
    return torch.cat(out), torch.cat(counts)


def pixel_mean(samples: list, spp: int):
    """A pixel's film value from its samples in sample order: summed one
    after another, then divided by the sample count."""
    acc = samples[0]
    for s in samples[1:]:
        acc = acc + s
    return acc / torch.tensor(float(spp), dtype=acc.dtype, device=acc.device)
