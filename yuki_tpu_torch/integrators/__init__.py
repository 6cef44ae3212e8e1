"""Path integrator: port of ``yuki_tpu/integrators/__init__.py``'s
``PathParams`` (:40-42), ``LiResult`` (:93-97) and ``path_li`` (:190-392).

The dense path-tracing wave (``ops/path_fused.py``) is the path tracer
for the dense scenes it accepts.  ``path_li`` is the path tracer for
every other scene, dense (the dense trace sweeps) or treelet (the
adaptive dispatch): its fused-shade branch (:234-314), bounce by bounce a
closest-hit query, the shade kernel, one light-major occlusion query for
every light's shadow rays, and the resolve kernel.  Both samplers run
there; a StratifiedSampler's values of each bounce are computed first
and read by the shade kernel as planes.  yuki_tpu's XLA shading chain
(:316-377: make_surface, gather_materials, _nee, bsdf_sample, built on
``surface.py``, ``bsdf.py`` and ``lights.py``), which runs where the fused
gate fails, is not ported: ``path_li`` raises there.  Whitted and the
debug integrators are not ported either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch


@dataclass(frozen=True)
class PathParams:
    max_depth: int = 3
    indirect_clamp: Optional[float] = None


class LiResult(NamedTuple):
    li: torch.Tensor  # [N,3]
    ray_count: torch.Tensor  # [N] i32 closest-hit traversals (shadow rays
    # are traced, not counted: path.rs:97)


def check_path_li_supported(meta, sampler) -> None:
    """Raise NotImplementedError, naming what is missing, where the port's
    path_li cannot run the scene."""
    from ..ops import shade_fused

    if len(meta.light_types) == 0 or not shade_fused.fused_shade_supported(
            meta, sampler):
        raise NotImplementedError(
            "path_li outside the fused-shade gate (a lightless scene, a "
            "textured sphere, or a sampler other than UniformSampler and "
            "StratifiedSampler) runs on the XLA shading chain (surface.py, "
            "bsdf.py, lights.py), which is not ported"
        )


def _ph_i32(ctx) -> torch.Tensor:
    """pcg(pixel_hash ^ sample_index) per lane, as int32 bits."""
    from ..sampling import _u32, pcg_hash

    ph = ctx.pixel_hash()
    u = pcg_hash(ph ^ _u32(ctx.sample_index, ph.device))
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def path_li(scene, meta, params: PathParams, sampler, ctx, o, d,
            tables=None, dim: int = 2) -> LiResult:
    """Path tracing with NEE every bounce, optional indirect clamp and
    Russian roulette after bounce 3 (path.rs:48-178), for dense and
    treelet scenes (``traverse.intersect`` / ``any_intersect`` with
    ``skip_sort=True``, as yuki_tpu's path_li calls them).

    Sampler dimensions advance by 2L+3 per bounce (2 per light, 2 for the
    BSDF sample, 1 for roulette, reserved on every bounce).  Dead lanes
    trace a zero-length ray (t_max 0) parked at the scene centre.
    ``tables``: ``shade_fused.make_shade_tables(scene, params)``, built
    here when None."""
    from .. import traverse
    from ..ops import shade_fused
    from ..ops.path_fused import bounce_draws
    from ..sampling import StratifiedSampler

    check_path_li_supported(meta, sampler)
    data = scene.data
    if tables is None:
        tables = shade_fused.make_shade_tables(scene, params)
    n_lights = len(meta.light_types)
    dims_per_bounce = 2 * n_lights + 2 + 1
    n = o.shape[0]
    dev = o.device
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
        hit = traverse.intersect(data, meta, o, d, t_max, skip_sort=True)
        missed = alive & ~hit.hit
        alive = alive & hit.hit
        (o2, d2, beta2, alive2, spec2, no, nd, nt, ns_skip, nw, nc,
         ne) = shade_fused.shade_fused(tables, hit, o, d, beta, alive,
                                       specular_bounce, ph, dim0, bounce,
                                       spl)
        occ = traverse.any_intersect(data, meta, no, nd, nt, ns_skip,
                                     skip_sort=True)
        radiance = shade_fused.resolve_fused(tables, radiance, beta, alive,
                                             missed, ne, occ, nw, nc, bounce)
        o, d, beta, alive, specular_bounce = o2, d2, beta2, alive2, spec2
    return LiResult(li=radiance, ray_count=ray_count)
