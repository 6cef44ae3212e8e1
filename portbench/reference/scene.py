"""The reference renderer's scene: plain tables built from a scene
description (meshes, spheres, materials, lights, textures), with no
acceleration structure.

``RefBuilder`` takes the same description a scene file or a scene's
construction gives (object-to-world transforms, indexed meshes, material
and light parameters) and bakes world-space triangle tables the way yuki
states it (shapes/mesh.rs: points pre-transformed, normals by the inverse
transpose, the default (0,0) (1,0) (1,1) uvs).  ``build`` puts them on a
device in a dtype: float32 for the reference, bfloat16 for its control.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from .rmath import IDENTITY, Xf, scale, translation
from .shading import (LIGHT_DISTANT, LIGHT_POINT, LIGHT_RECT, MAT_GLASS,
                      MAT_GLOSSY, MAT_MATTE, MAT_METAL)


@dataclass
class RefScene:
    tri: SimpleNamespace
    sph: SimpleNamespace
    mat: SimpleNamespace
    lights: list
    light_i: torch.Tensor
    tex: SimpleNamespace
    background: torch.Tensor
    world_lo: torch.Tensor
    world_hi: torch.Tensor
    light_types: tuple
    material_types: tuple

    @property
    def n_tris(self) -> int:
        return int(self.tri.p0.shape[0])

    @property
    def n_spheres(self) -> int:
        return int(self.sph.radius.shape[0])

    @property
    def dtype(self):
        return self.tri.p0.dtype


class RefBuilder:
    def __init__(self):
        self.tri_p, self.tri_n, self.tri_uv = [], [], []
        self.tri_has_ns, self.tri_swaps, self.tri_mat, self.tri_light = [], [], [], []
        self.spheres = []
        self.materials = []
        self.lights = []
        self.textures = []
        self.background = np.zeros(3, np.float32)

    def _material(self, mtype, c0, c1=(0, 0, 0), s0=0.0, remap=False,
                  tex0=-1, tex1=-1) -> int:
        self.materials.append((mtype, c0, c1, s0, remap, tex0, tex1))
        return len(self.materials) - 1

    def add_matte(self, kd=(1.0, 1.0, 1.0), sigma=0.0, kd_tex=-1, sigma_tex=-1):
        return self._material(MAT_MATTE, kd, (0, 0, 0), sigma, False, kd_tex,
                              sigma_tex)

    def add_glass(self, r=(1.0, 1.0, 1.0), t=(1.0, 1.0, 1.0), eta=1.5):
        return self._material(MAT_GLASS, r, t, eta)

    def add_metal(self, eta, k, roughness, remap=True):
        return self._material(MAT_METAL, eta, k, roughness, remap)

    def add_glossy(self, rs, roughness, remap=True):
        return self._material(MAT_GLOSSY, rs, (0, 0, 0), roughness, remap)

    def add_texture(self, image: np.ndarray) -> int:
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def _light(self, **row) -> int:
        base = dict(p=(0.0, 0.0, 0.0), m=IDENTITY.m, area=0.0, cos_w=0.0,
                    cos_f=0.0)
        base.update(row)
        self.lights.append(base)
        return len(self.lights) - 1

    def add_point_light(self, position, intensity) -> int:
        return self._light(type=LIGHT_POINT,
                           p=translation(position).apply_p((0.0, 0.0, 0.0)),
                           i=intensity)

    def add_rect_light(self, light_to_world: Xf, radiance, size_xy) -> int:
        """A rectangle facing -y: its samples are sample_to_world of
        (u, 0, v) for u, v in [0, 1)."""
        sx, sy = np.asarray(size_xy, dtype=np.float32)
        s2w = light_to_world @ (scale(sx, 1.0, sy) @ translation((-0.5, 0.0, -0.5)))
        return self._light(type=LIGHT_RECT, i=radiance, m=s2w.m,
                           area=float(sx * sy))

    def add_distant_light(self, radiance, w) -> int:
        return self._light(type=LIGHT_DISTANT, p=np.asarray(w, np.float32),
                           i=radiance)

    def add_mesh(self, xf: Xf, indices, points, normals=None, uvs=None,
                 material=0, area_light=-1) -> None:
        idx = np.asarray(indices, np.int64).reshape(-1, 3)
        if idx.shape[0] == 0:
            return
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        m = xf.m
        w = pts @ m[3, :3].T + m[3, 3]
        pw = (pts @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        if not np.allclose(w, 1.0):
            pw = (pw / w[:, None]).astype(np.float32)
        n_tri = idx.shape[0]
        if normals is not None and len(normals):
            nw = (np.asarray(normals, np.float32).reshape(-1, 3)
                  @ xf.m_inv[:3, :3]).astype(np.float32)
            self.tri_n.append(nw[idx])
            has_ns = True
        else:
            self.tri_n.append(np.zeros((n_tri, 3, 3), np.float32))
            has_ns = False
        if uvs is not None and len(uvs):
            self.tri_uv.append(np.asarray(uvs, np.float32).reshape(-1, 2)[idx])
        else:
            self.tri_uv.append(np.broadcast_to(
                np.array([[0, 0], [1, 0], [1, 1]], np.float32),
                (n_tri, 3, 2)).copy())
        self.tri_p.append(pw[idx])
        self.tri_has_ns.append(np.full(n_tri, has_ns))
        self.tri_swaps.append(np.full(n_tri, xf.swaps_handedness()))
        self.tri_mat.append(np.full(n_tri, material, np.int64))
        self.tri_light.append(np.full(n_tri, area_light, np.int64))

    def add_sphere(self, xf: Xf, radius: float, material: int) -> None:
        self.spheres.append((xf, float(radius), int(material)))

    def build(self, device, dtype=torch.float32) -> RefScene:
        f = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                      device=device).to(dtype)
        i = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int64),
                                      device=device)
        b = lambda a: torch.as_tensor(np.ascontiguousarray(a, bool),
                                      device=device)
        tp = np.concatenate(self.tri_p)
        tn = np.concatenate(self.tri_n)
        tuv = np.concatenate(self.tri_uv)
        tri = SimpleNamespace(
            p0=f(tp[:, 0]), p1=f(tp[:, 1]), p2=f(tp[:, 2]),
            n0=f(tn[:, 0]), n1=f(tn[:, 1]), n2=f(tn[:, 2]),
            uv0=f(tuv[:, 0]), uv1=f(tuv[:, 1]), uv2=f(tuv[:, 2]),
            has_ns=b(np.concatenate(self.tri_has_ns)),
            swaps=b(np.concatenate(self.tri_swaps)),
            mat=i(np.concatenate(self.tri_mat)),
            light=i(np.concatenate(self.tri_light)))
        lo, hi = tp.reshape(-1, 3).min(axis=0), tp.reshape(-1, 3).max(axis=0)
        o2w, w2o, rad, swp, smat = [], [], [], [], []
        for xf, r, mt in self.spheres:
            o2w.append(xf.m)
            w2o.append(xf.m_inv)
            rad.append(r)
            swp.append(xf.swaps_handedness())
            smat.append(mt)
            corners = np.array([[x, y, z] for x in (-r, r) for y in (-r, r)
                                for z in (-r, r)], np.float32)
            wc = np.stack([xf.apply_p(c) for c in corners])
            lo, hi = np.minimum(lo, wc.min(axis=0)), np.maximum(hi, wc.max(axis=0))
        ns = len(self.spheres)
        sph = SimpleNamespace(
            o2w=f(np.stack(o2w) if ns else np.zeros((0, 4, 4))),
            w2o=f(np.stack(w2o) if ns else np.zeros((0, 4, 4))),
            radius=f(np.asarray(rad, np.float32)),
            swaps=b(np.asarray(swp, bool)), mat=i(np.asarray(smat, np.int64)))
        mats = self.materials
        mat = SimpleNamespace(
            mtype=i([m[0] for m in mats]),
            c0=f([m[1] for m in mats]), c1=f([m[2] for m in mats]),
            s0=f([m[3] for m in mats]), remap=b([m[4] for m in mats]),
            tex0=i([m[5] for m in mats]), tex1=i([m[6] for m in mats]))
        lights = []
        for row in self.lights:
            lights.append(dict(type=row["type"], p=f(row["p"]), i=f(row["i"]),
                               m=f(np.asarray(row["m"], np.float32)),
                               area=f(row["area"]), cos_w=f(row["cos_w"]),
                               cos_f=f(row["cos_f"])))
        light_i = (f([row["i"] for row in self.lights]) if self.lights
                   else f(np.zeros((1, 3))))
        if self.textures:
            offs, ws, hs, off = [], [], [], 0
            for img in self.textures:
                offs.append(off)
                hs.append(img.shape[0])
                ws.append(img.shape[1])
                off += img.shape[0] * img.shape[1]
            texels = np.concatenate([t.reshape(-1, 3) for t in self.textures])
        else:
            offs, ws, hs, texels = [0], [1], [1], np.zeros((1, 3), np.float32)
        tex = SimpleNamespace(texels=f(texels), offset=i(offs), width=i(ws),
                              height=i(hs))
        return RefScene(
            tri=tri, sph=sph, mat=mat, lights=lights, light_i=light_i,
            tex=tex, background=f(self.background), world_lo=f(lo),
            world_hi=f(hi),
            light_types=tuple(int(r["type"]) for r in self.lights),
            material_types=tuple(sorted({int(m[0]) for m in mats})))

