"""Wavefront light sampling: port of ``yuki_tpu/lights.py`` (:30-130).

Each light's type is static host-side metadata (``SceneMeta.light_types``),
so the integrators loop over the lights in Python and call the matching
sampler; parameter rows come from the scene's ``LightArrays``.

Reference parity:
  PointLight::sample_li        lights/point_light.rs:26-50
  SpotLight::sample_li/falloff lights/spot_light.rs:39-95
  RectangularLight::sample_li  lights/rectangular_light.rs:44-71
  RectangularLight::radiance   lights/rectangular_light.rs:74-82
  DistantLight::sample_li      lights/distant_light.rs:24-44
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .scene.data import LIGHT_DISTANT, LIGHT_POINT, LIGHT_RECT, LIGHT_SPOT
from .surface import Surface
from .transforms import apply_p, apply_v
from .vecmath import dot, normalize_safe, sqrt

# The shadow-skip id of a light that is no area light: it must match no
# triangle's area_light (-1 marks ordinary geometry, so -1 would skip
# everything; the reference passes Option::None, bvh.rs:287-293).
NO_SKIP = -2


class LightSample(NamedTuple):
    l: torch.Tensor  # [N,3] direction to the light (normalized)
    li: torch.Tensor  # [N,3] incident radiance
    pdf: torch.Tensor  # [N]
    target: torch.Tensor  # [N,3] visibility test endpoint
    skip_light: torch.Tensor  # [N] i32 area-light id the shadow ray skips


def _toward(p, si: Surface):
    """(direction, squared distance clamped at 1e-30) from the lanes to
    the point p [3]."""
    to_l = p - si.p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-30)
    return to_l / sqrt(d2)[..., None], d2


def sample_li(scene, light_index: int, light_type: int, si: Surface,
              u) -> LightSample:
    """Sample the light ``light_index`` (of type ``light_type``) for every
    lane; ``u`` [N,2] (read by rect lights only)."""
    L = scene.lights
    shape = si.p.shape[:-1]
    dev = si.p.device
    ones = torch.ones(shape, dtype=torch.float32, device=dev)
    no_skip = torch.full(shape, NO_SKIP, dtype=torch.int32, device=dev)

    if light_type == LIGHT_POINT:
        p = L.p[light_index]
        l, d2 = _toward(p, si)
        return LightSample(l=l, li=L.i[light_index] / d2[..., None], pdf=ones,
                           target=p.expand(si.p.shape), skip_light=no_skip)

    if light_type == LIGHT_SPOT:
        p = L.p[light_index]
        l, d2 = _toward(p, si)
        # Falloff (spot_light.rs:39-53).
        ct = normalize_safe(apply_v(L.m[light_index], -l))[..., 2]
        cos_w, cos_f = L.cos_w[light_index], L.cos_f[light_index]
        delta = (ct - cos_w) / torch.clamp(cos_f - cos_w, min=1e-30)
        fall = torch.where(ct < cos_w, 0.0,
                           torch.where(ct > cos_f, 1.0,
                                       (delta * delta) * (delta * delta)))
        return LightSample(l=l, li=L.i[light_index] * (fall / d2)[..., None],
                           pdf=ones, target=p.expand(si.p.shape),
                           skip_light=no_skip)

    if light_type == LIGHT_RECT:
        s2w = L.m[light_index]
        zeros = torch.zeros(shape, dtype=torch.float32, device=dev)
        p = apply_p(s2w, torch.stack([u[..., 0], zeros, u[..., 1]], dim=-1))
        # The light's normal: -y through sample_to_world (rigid, so the
        # linear part serves as the reference's Transform * Normal).
        down = torch.tensor([0.0, -1.0, 0.0], dtype=torch.float32,
                            device=dev)
        n = normalize_safe(apply_v(s2w, down)).expand(si.p.shape)
        wi = normalize_safe(p - si.p)
        front = dot(n, -wi) > 0.0
        li = torch.where(front[..., None], L.i[light_index], 0.0)
        dp = p - si.p
        d2 = dot(dp, dp)
        pdf = d2 / torch.clamp(torch.abs(dot(n, -wi)) * L.area[light_index],
                               min=1e-30)
        return LightSample(l=wi, li=li, pdf=pdf, target=p,
                           skip_light=torch.full(shape, light_index,
                                                 dtype=torch.int32,
                                                 device=dev))

    if light_type == LIGHT_DISTANT:
        w = L.p[light_index]
        # The shadow segment spans the scene box's diagonal with a 1.002
        # margin over the 0.9999 chord the shadow ray is traced to, so
        # that no occluder inside the box is missed.
        ext = scene.world_hi - scene.world_lo
        diag = sqrt(dot(ext, ext)) * 1.002 + 1e-3
        return LightSample(l=w.expand(si.p.shape),
                           li=L.i[light_index].expand(si.p.shape), pdf=ones,
                           target=si.p + w * diag, skip_light=no_skip)

    raise ValueError(f"unknown light type {light_type}")


def area_light_radiance(scene, si: Surface, w: torch.Tensor) -> torch.Tensor:
    """Emitted radiance of lanes whose primitive carries an area light
    (interaction.rs:134-138; one-sided rect emission,
    rectangular_light.rs:74-82)."""
    has = si.area_light >= 0
    le = scene.lights.i[torch.clamp(si.area_light, min=0).to(torch.int64)]
    front = dot(si.n, w) > 0.0
    return torch.where((has & front)[..., None], le, 0.0)
