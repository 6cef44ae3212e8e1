"""Scene representation: dataclasses of tensors + a host-side builder.

Port of ``yuki_tpu/scene/data.py``.  Everything the integrators touch per
ray lives in flat tensors on the scene's device: world-space triangles
with a one-row ``[T,32]`` shading table, spheres with their
object<->world matrices (tested brute-force after the triangles), and
material / light / texture tables keyed by type id.  The tables are
computed in numpy exactly as ``yuki_tpu`` computes them, so the two
packages hold the same bits.

``build`` makes the SAH BVH on the host for every scene (its root box is
the scene box; its threaded form on the device, ``SceneData.bvh``, is
what ``traverse.intersect_bvh`` walks); scenes above ``DENSE_TRI_THRESHOLD`` triangles also get
the two-level treelet structure the treelet walk reads and the flat
~128-triangle chunk cut the adaptive dispatch's probe, cull and slot
stream read (``traverse``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .. import transforms as tf
from ..bvh import build_bvh
from ..device import resolve_device
from ..treelets import build_treelets

# Material type ids (materials/{matte,glass,metal,glossy}.rs)
MAT_MATTE = 0
MAT_GLASS = 1
MAT_METAL = 2
MAT_GLOSSY = 3

# Above this triangle count yuki_tpu switches to treelet traversal.
DENSE_TRI_THRESHOLD = 4096

# Light type ids (lights/{point,spot,rectangular,distant}_light.rs)
LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_RECT = 2
LIGHT_DISTANT = 3


@dataclass
class TriangleArrays:
    """World-space triangle soup. All [T, ...]; T >= 1 (padded)."""

    p0: Any
    p1: Any
    p2: Any
    n0: Any  # shading normals; garbage when has_ns is False
    n1: Any
    n2: Any
    uv0: Any  # [T,2]
    uv1: Any
    uv2: Any
    has_ns: Any  # [T] bool — mesh had authored normals
    has_uv: Any  # [T] bool — mesh had authored uvs
    swaps_hand: Any  # [T] bool — mesh object_to_world swaps handedness
    material: Any  # [T] i32
    area_light: Any  # [T] i32 (-1 = none)
    # [T,32] f32 shading row: p0,p1,p2 | n0,n1,n2 | uv0,uv1,uv2 | has_ns,
    # swaps, material, area_light (ids stored exactly as small floats).
    shading_packed: Any


@dataclass
class SphereArrays:
    """All [S, ...]; S may be 0."""

    obj_to_world: Any  # [S,4,4]
    world_to_obj: Any  # [S,4,4]
    radius: Any  # [S]
    swaps_hand: Any  # [S] bool
    material: Any  # [S] i32


@dataclass
class MaterialArrays:
    """Material parameter table, [M, ...].

    Per type the slots mean:
      MATTE : c0=kd          s0=sigma(radians)  tex0=kd tex  tex1=sigma tex
      GLASS : c0=R  c1=T     s0=eta
      METAL : c0=eta c1=k    s0=roughness  remap
      GLOSSY: c0=Rs          s0=roughness  remap
    """

    mtype: Any  # [M] i32
    c0: Any  # [M,3]
    c1: Any  # [M,3]
    s0: Any  # [M]
    remap: Any  # [M] bool
    tex0: Any  # [M] i32 texture id for c0, -1 = constant
    tex1: Any  # [M] i32 texture id for s0, -1 = constant
    packed: Any  # [M,16] f32: mtype, c0(3), c1(3), s0, remap, tex0, tex1


@dataclass
class LightArrays:
    """Light parameter table, [L, ...]. L >= 1 (a zero-intensity point light
    is padded in for lightless scenes).

    Slots per type:
      POINT  : p=position         i=intensity
      SPOT   : p=position         i=intensity    m=world_to_light
               cos_w=cos(total_width) cos_f=cos(falloff_start)
      RECT   : i=radiance  m=sample_to_world  area=size.x*size.y
      DISTANT: p=direction w      i=radiance
    """

    ltype: Any  # [L] i32
    p: Any  # [L,3]
    i: Any  # [L,3]
    m: Any  # [L,4,4]
    area: Any  # [L]
    cos_w: Any  # [L]
    cos_f: Any  # [L]


@dataclass
class TextureAtlas:
    """Flat texel pool; per-texture offset/size. Point-sampled, repeat-wrap,
    y-flip (textures/image_texture.rs:85-106)."""

    texels: Any  # [N,3] f32 (at least 1)
    offset: Any  # [K] i32
    width: Any  # [K] i32
    height: Any  # [K] i32
    # [N,3] u8 pool, present only when every texel is exactly k/255.
    texels_u8: Any = None
    # Present when the u8 pool has <= 128 distinct RGB triples: [N] i32
    # palette index per texel + [P,3] f32 integer u8 colour values.
    pal_idx: Any = None
    palette: Any = None


@dataclass
class SceneData:
    """The device-resident scene tables handed to the integrators."""

    tris: TriangleArrays
    spheres: SphereArrays
    materials: MaterialArrays
    lights: LightArrays
    textures: TextureAtlas
    background: Any  # [3]
    world_lo: Any  # [3] scene AABB (BVH root + sphere boxes)
    world_hi: Any  # [3]
    treelets: Any = None  # treelets.TreeletArrays (treelet scenes only)
    chunks: Any = None  # treelets.TreeletArrays: flat ~128-tri cut
    bvh: Any = None  # bvh.BvhArrays, the threaded BVH the walks read


@dataclass
class SceneMeta:
    """Host-side static facts about the scene; same fields as
    ``yuki_tpu.scene.data.SceneMeta``."""

    name: str = "scene"
    n_tris: int = 0
    n_spheres: int = 0
    n_lights: int = 0
    n_materials: int = 0
    light_types: tuple = ()
    # Fattest BVH leaf.
    bvh_max_leaf: int = 4
    traversal: str = "dense"
    material_types: tuple = (0,)
    has_sigma: bool = False
    has_textures: bool = False
    has_sigma_tex: bool = False
    # Treelet slot-stream budgets (_estimate_slot_mult; the slot branch of
    # traverse's adaptive dispatch).
    slot_mult: int = 6
    slot_mult_tight: int = 4
    bun_closest: int = 1
    c_closest: int = 64
    bun_any: int = 1
    c_any: int = 96
    sphere_mats_untextured: bool = True
    texpool_texels: int = 1
    texpool_u8_exact: bool = False
    texpool_palette: int = 0
    n_textures: int = 0


@dataclass
class Scene:
    """Tensors + static metadata."""

    data: SceneData
    meta: SceneMeta
    bvh_host: Any = None  # bvh.BvhHost
    # Host seconds of build's stages: "bvh", and for treelet scenes
    # "treelets", "chunks" and "slot_mult".
    build_seconds: dict = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.meta.name

    @property
    def device(self) -> torch.device:
        return self.data.tris.p0.device


def _estimate_slot_mult(chunks, tri_p, n_sample: int = 8192,
                        seed: int = 17) -> tuple[int, int]:
    """Sampled diffuse-bounce chunk incidence -> static slot budgets
    (tight, wide), yuki_tpu scene/data.py:271-308: random surface points
    with hemisphere directions slab-tested against every chunk box; wide
    = mean * 1.3 + 2 clamped to [6, 16], tight = mean * 0.66 + 1 clamped
    to [4, wide]."""
    cb = chunks.treelet_bounds.cpu().numpy()
    rng = np.random.default_rng(seed)
    nt = tri_p.shape[0]
    ids = rng.integers(0, nt, n_sample)
    u = rng.random((n_sample, 1)).astype(np.float32)
    v = (rng.random((n_sample, 1)) * (1 - u)).astype(np.float32)
    p0, p1, p2 = tri_p[ids, 0], tri_p[ids, 1], tri_p[ids, 2]
    orig = p0 + u * (p1 - p0) + v * (p2 - p0)
    nrm = np.cross(p1 - p0, p2 - p0)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    dirs = rng.standard_normal((n_sample, 3)).astype(np.float32)
    dirs /= np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12)
    flip = (dirs * nrm).sum(1, keepdims=True) < 0
    dirs = np.where(flip, -dirs, dirs).astype(np.float32)
    orig = (orig + 1e-3 * nrm).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
        t0 = (cb[None, :, 0:3] - orig[:, None, :]) * inv[:, None, :]
        t1 = (cb[None, :, 3:6] - orig[:, None, :]) * inv[:, None, :]
    tn = np.nan_to_num(np.minimum(t0, t1), nan=-np.inf).max(axis=2)
    tf_ = np.nan_to_num(np.maximum(t0, t1), nan=np.inf).min(axis=2)
    mean_inc = float((np.maximum(tn, 0.0) <= tf_).sum(axis=1).mean())
    wide = int(np.clip(np.ceil(mean_inc * 1.3) + 2, 6, 16))
    tight = int(np.clip(np.ceil(mean_inc * 0.66) + 1, 4, wide))
    return tight, wide


def _t(x, device, dtype=None) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


class SceneBuilder:
    """Accumulates host-side geometry then freezes it into a Scene
    (the role of the reference's loaders filling Scene, scene/mod.rs)."""

    def __init__(self, name: str = "scene"):
        self.name = name
        self._tri_p = []  # [n,3,3] per mesh
        self._tri_n = []
        self._tri_uv = []
        self._tri_flags = []  # (has_ns, has_uv, swaps_hand)
        self._tri_mat = []
        self._tri_light = []
        self._spheres = []  # (o2w 4x4, w2o 4x4, radius, swaps, mat)
        self._materials = []  # dict rows
        self._lights = []  # dict rows
        self._textures = []  # np [h,w,3] f32
        self.background = np.zeros(3, dtype=np.float32)

    # --- materials -----------------------------------------------------
    def _add_material(self, row) -> int:
        self._materials.append(row)
        return len(self._materials) - 1

    def add_matte(self, kd=(1.0, 1.0, 1.0), sigma: float = 0.0, kd_tex: int = -1,
                  sigma_tex: int = -1) -> int:
        return self._add_material(
            dict(mtype=MAT_MATTE, c0=kd, c1=(0, 0, 0), s0=sigma, remap=False,
                 tex0=kd_tex, tex1=sigma_tex)
        )

    def add_glass(self, r=(1.0, 1.0, 1.0), t=(1.0, 1.0, 1.0), eta: float = 1.5) -> int:
        return self._add_material(
            dict(mtype=MAT_GLASS, c0=r, c1=t, s0=eta, remap=False, tex0=-1, tex1=-1)
        )

    def add_metal(self, eta, k, roughness: float, remap_roughness: bool = True) -> int:
        return self._add_material(
            dict(mtype=MAT_METAL, c0=eta, c1=k, s0=roughness,
                 remap=remap_roughness, tex0=-1, tex1=-1)
        )

    def add_glossy(self, rs, roughness: float, remap_roughness: bool = True) -> int:
        return self._add_material(
            dict(mtype=MAT_GLOSSY, c0=rs, c1=(0, 0, 0), s0=roughness,
                 remap=remap_roughness, tex0=-1, tex1=-1)
        )

    # --- textures ------------------------------------------------------
    def add_texture(self, image: np.ndarray) -> int:
        """image: [h,w,3] float32 linear RGB."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"texture must be [h,w,3], got {image.shape}")
        self._textures.append(np.asarray(image, dtype=np.float32))
        return len(self._textures) - 1

    # --- lights --------------------------------------------------------
    def add_point_light(self, light_to_world: tf.Transform, intensity) -> int:
        self._lights.append(
            dict(ltype=LIGHT_POINT, p=light_to_world.apply_p((0.0, 0.0, 0.0)),
                 i=intensity, m=tf.IDENTITY, area=0.0, cos_w=0.0, cos_f=0.0)
        )
        return len(self._lights) - 1

    def add_spot_light(
        self, light_to_world: tf.Transform, intensity,
        total_width_deg: float, falloff_start_deg: float,
    ) -> int:
        self._lights.append(
            dict(
                ltype=LIGHT_SPOT,
                p=light_to_world.apply_p((0.0, 0.0, 0.0)),
                i=intensity,
                m=light_to_world.m_inv,  # world_to_light
                area=0.0,
                cos_w=np.cos(np.radians(total_width_deg)),
                cos_f=np.cos(np.radians(falloff_start_deg)),
            )
        )
        return len(self._lights) - 1

    def add_rect_light(self, light_to_world: tf.Transform, radiance, size_xy) -> int:
        """Rect area light facing -Y (lights/rectangular_light.rs:23-46)."""
        sx, sy = np.asarray(size_xy, dtype=np.float32)
        sample_to_light = tf.scale(sx, 1.0, sy) @ tf.translation((-0.5, 0.0, -0.5))
        s2w = light_to_world @ sample_to_light
        self._lights.append(
            dict(ltype=LIGHT_RECT, p=(0.0, 0.0, 0.0), i=radiance, m=s2w.m,
                 area=float(sx * sy), cos_w=0.0, cos_f=0.0)
        )
        return len(self._lights) - 1

    def add_distant_light(self, radiance, w) -> int:
        self._lights.append(
            dict(ltype=LIGHT_DISTANT, p=np.asarray(w, dtype=np.float32),
                 i=radiance, m=tf.IDENTITY, area=0.0, cos_w=0.0, cos_f=0.0)
        )
        return len(self._lights) - 1

    # --- geometry ------------------------------------------------------
    def add_mesh(
        self,
        object_to_world: tf.Transform,
        indices,
        points,
        normals=None,
        uvs=None,
        material: int = 0,
        area_light: int = -1,
    ) -> None:
        """Add all triangles of an indexed mesh, pre-transformed to world
        space like Mesh::new (yuki/src/shapes/mesh.rs:20-44)."""
        idx = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
        n_tri = idx.shape[0]
        if n_tri == 0:
            return
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        m = object_to_world.m
        w = pts @ m[3, :3].T + m[3, 3]
        pts_w = (pts @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        if not np.allclose(w, 1.0):
            pts_w = (pts_w / w[:, None]).astype(np.float32)
        has_ns = normals is not None and len(normals) > 0
        has_uv = uvs is not None and len(uvs) > 0
        if has_ns:
            nrm = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
            nrm_w = (nrm @ object_to_world.m_inv[:3, :3]).astype(np.float32)
            tri_n = nrm_w[idx]  # [T,3,3]
        else:
            tri_n = np.zeros((n_tri, 3, 3), np.float32)
        if has_uv:
            uvarr = np.asarray(uvs, dtype=np.float32).reshape(-1, 2)
            tri_uv = uvarr[idx]
        else:
            # Default triangle uvs (shapes/triangle.rs:139-145).
            tri_uv = np.broadcast_to(
                np.array([[0, 0], [1, 0], [1, 1]], dtype=np.float32),
                (n_tri, 3, 2),
            ).copy()
        swaps = object_to_world.swaps_handedness()
        self._tri_p.append(pts_w[idx])
        self._tri_n.append(tri_n)
        self._tri_uv.append(tri_uv)
        self._tri_flags.append(
            np.broadcast_to(
                np.asarray([has_ns, has_uv, swaps], dtype=bool), (n_tri, 3)
            ).copy()
        )
        self._tri_mat.append(np.full(n_tri, material, dtype=np.int32))
        self._tri_light.append(np.full(n_tri, area_light, dtype=np.int32))

    def add_sphere(self, object_to_world: tf.Transform, radius: float, material: int) -> None:
        self._spheres.append(
            (
                object_to_world.m,
                object_to_world.m_inv,
                float(radius),
                object_to_world.swaps_handedness(),
                int(material),
            )
        )

    # --- freeze --------------------------------------------------------
    def build(self, split_method: str = "sah", max_shapes_in_node: int = 1,
              device=None) -> Scene:
        """Freeze into a Scene on ``device`` (None: default_device()); the
        BVH arguments are yuki_tpu's (scene/data.py:498-503, whose
        max_leaf_size stays at its default 4 here)."""
        dev = resolve_device(device)
        nt = sum(chunk.shape[0] for chunk in self._tri_p)
        ns = len(self._spheres)

        tri_p_chunks = list(self._tri_p)
        tri_n_chunks = list(self._tri_n)
        tri_uv_chunks = list(self._tri_uv)
        flag_chunks = list(self._tri_flags)
        mat_chunks = list(self._tri_mat)
        light_chunks = list(self._tri_light)
        if nt == 0:
            # Pad one degenerate triangle so array shapes stay valid.
            tri_p_chunks.append(np.full((1, 3, 3), np.inf, dtype=np.float32))
            tri_n_chunks.append(np.zeros((1, 3, 3), np.float32))
            tri_uv_chunks.append(np.zeros((1, 3, 2), np.float32))
            flag_chunks.append(np.zeros((1, 3), dtype=bool))
            mat_chunks.append(np.zeros(1, dtype=np.int32))
            light_chunks.append(np.full(1, -1, dtype=np.int32))

        tri_p = np.concatenate(tri_p_chunks)  # [T,3,3]
        tri_n = np.concatenate(tri_n_chunks)
        tri_uv = np.concatenate(tri_uv_chunks)
        flags = np.concatenate(flag_chunks)
        tri_mat_np = np.concatenate(mat_chunks)
        tri_light_np = np.concatenate(light_chunks)
        t_count = tri_p.shape[0]
        packed = np.zeros((t_count, 32), dtype=np.float32)
        packed[:, 0:9] = tri_p.reshape(t_count, 9)
        packed[:, 9:18] = tri_n.reshape(t_count, 9)
        packed[:, 18:24] = tri_uv.reshape(t_count, 6)
        packed[:, 24] = flags[:, 0]  # has_ns
        packed[:, 25] = flags[:, 2]  # swaps_hand
        packed[:, 26] = tri_mat_np
        packed[:, 27] = tri_light_np
        tris = TriangleArrays(
            p0=_t(tri_p[:, 0], dev), p1=_t(tri_p[:, 1], dev),
            p2=_t(tri_p[:, 2], dev),
            n0=_t(tri_n[:, 0], dev), n1=_t(tri_n[:, 1], dev),
            n2=_t(tri_n[:, 2], dev),
            uv0=_t(tri_uv[:, 0], dev), uv1=_t(tri_uv[:, 1], dev),
            uv2=_t(tri_uv[:, 2], dev),
            has_ns=_t(flags[:, 0], dev), has_uv=_t(flags[:, 1], dev),
            swaps_hand=_t(flags[:, 2], dev),
            material=_t(tri_mat_np, dev), area_light=_t(tri_light_np, dev),
            shading_packed=_t(packed, dev),
        )

        if ns:
            o2w = np.stack([s[0] for s in self._spheres])
            w2o = np.stack([s[1] for s in self._spheres])
            rad = np.asarray([s[2] for s in self._spheres], dtype=np.float32)
            ssw = np.asarray([s[3] for s in self._spheres], dtype=bool)
            smat = np.asarray([s[4] for s in self._spheres], dtype=np.int32)
        else:
            o2w = np.zeros((0, 4, 4), np.float32)
            w2o = np.zeros((0, 4, 4), np.float32)
            rad = np.zeros((0,), np.float32)
            ssw = np.zeros((0,), bool)
            smat = np.zeros((0,), np.int32)
        spheres = SphereArrays(
            obj_to_world=_t(o2w, dev), world_to_obj=_t(w2o, dev),
            radius=_t(rad, dev), swaps_hand=_t(ssw, dev),
            material=_t(smat, dev),
        )

        mats = self._materials or [
            dict(mtype=MAT_MATTE, c0=(1, 1, 1), c1=(0, 0, 0), s0=0.0,
                 remap=False, tex0=-1, tex1=-1)
        ]
        mat_packed = np.zeros((len(mats), 16), dtype=np.float32)
        mat_packed[:, 0] = [m["mtype"] for m in mats]
        mat_packed[:, 1:4] = np.asarray([m["c0"] for m in mats], np.float32)
        mat_packed[:, 4:7] = np.asarray([m["c1"] for m in mats], np.float32)
        mat_packed[:, 7] = [m["s0"] for m in mats]
        mat_packed[:, 8] = [float(m["remap"]) for m in mats]
        mat_packed[:, 9] = [m["tex0"] for m in mats]
        mat_packed[:, 10] = [m.get("tex1", -1) for m in mats]
        materials = MaterialArrays(
            mtype=_t(np.asarray([m["mtype"] for m in mats], np.int32), dev),
            c0=_t(np.asarray([m["c0"] for m in mats], np.float32), dev),
            c1=_t(np.asarray([m["c1"] for m in mats], np.float32), dev),
            s0=_t(np.asarray([m["s0"] for m in mats], np.float32), dev),
            remap=_t(np.asarray([m["remap"] for m in mats], bool), dev),
            tex0=_t(np.asarray([m["tex0"] for m in mats], np.int32), dev),
            tex1=_t(np.asarray([m.get("tex1", -1) for m in mats], np.int32),
                    dev),
            packed=_t(mat_packed, dev),
        )

        lrows = self._lights or [
            dict(ltype=LIGHT_POINT, p=(0, 0, 0), i=(0, 0, 0), m=tf.IDENTITY,
                 area=0.0, cos_w=0.0, cos_f=0.0)
        ]
        lights = LightArrays(
            ltype=_t(np.asarray([l["ltype"] for l in lrows], np.int32), dev),
            p=_t(np.asarray([l["p"] for l in lrows], np.float32), dev),
            i=_t(np.asarray([l["i"] for l in lrows], np.float32), dev),
            m=_t(np.stack([np.asarray(l["m"], np.float32) for l in lrows]),
                 dev),
            area=_t(np.asarray([l["area"] for l in lrows], np.float32), dev),
            cos_w=_t(np.asarray([l["cos_w"] for l in lrows], np.float32), dev),
            cos_f=_t(np.asarray([l["cos_f"] for l in lrows], np.float32), dev),
        )

        if self._textures:
            offs, ws, hs, flat = [], [], [], []
            off = 0
            for img in self._textures:
                h, w, _ = img.shape
                offs.append(off)
                ws.append(w)
                hs.append(h)
                flat.append(img.reshape(-1, 3))
                off += h * w
            texels = np.concatenate(flat, axis=0)
        else:
            offs, ws, hs = [0], [1], [1]
            texels = np.zeros((1, 3), np.float32)
        # Exact-u8 pool companion, decided from the values.
        u8r = np.clip(np.round(texels * 255.0), 0, 255).astype(np.uint8)
        u8_exact = bool(
            np.array_equal(u8r.astype(np.float32) / np.float32(255.0), texels)
        )
        pal_colors = 0
        pal_idx = palette = None
        if u8_exact:
            uniq, inv = np.unique(u8r, axis=0, return_inverse=True)
            if uniq.shape[0] <= 128:
                pal_colors = int(uniq.shape[0])
                pal_idx = inv.astype(np.int32)
                palette = uniq.astype(np.float32)
        textures = TextureAtlas(
            texels=_t(texels, dev),
            offset=_t(np.asarray(offs, np.int32), dev),
            width=_t(np.asarray(ws, np.int32), dev),
            height=_t(np.asarray(hs, np.int32), dev),
            texels_u8=_t(u8r, dev) if u8_exact else None,
            pal_idx=_t(pal_idx, dev),
            palette=_t(palette, dev),
        )

        # BVH over triangles (spheres are tested brute-force); treelet
        # scenes also get the two-level treelet cut (fat 64-triangle
        # leaves) and the flat 128-triangle chunk cut.
        seconds = {}
        t0 = time.perf_counter()
        bvh_host = build_bvh(tri_p, split_method=split_method,
                             max_shapes_in_node=max_shapes_in_node)
        seconds["bvh"] = time.perf_counter() - t0
        treelet = nt > DENSE_TRI_THRESHOLD
        treelet_arrays = chunk_arrays = None
        slot_mult_tight, slot_mult = 4, 6
        if treelet:
            t0 = time.perf_counter()
            treelet_arrays = build_treelets(bvh_host, tri_p, tri_light_np,
                                            leaf_size=64, super_size=4096,
                                            device=dev)
            seconds["treelets"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            chunk_arrays = build_treelets(bvh_host, tri_p, tri_light_np,
                                          leaf_size=128, super_size=128,
                                          device=dev)
            seconds["chunks"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            slot_mult_tight, slot_mult = _estimate_slot_mult(chunk_arrays,
                                                             tri_p)
            seconds["slot_mult"] = time.perf_counter() - t0
        world_lo = bvh_host.node_lo[0].copy()
        world_hi = bvh_host.node_hi[0].copy()
        for s in self._spheres:
            t = tf.Transform(np.asarray(s[0]), np.asarray(s[1]))
            r = s[2]
            corners = np.array(
                [[x, y, z] for x in (-r, r) for y in (-r, r) for z in (-r, r)],
                dtype=np.float32,
            )
            wc = np.stack([t.apply_p(c) for c in corners])
            world_lo = np.minimum(world_lo, wc.min(axis=0))
            world_hi = np.maximum(world_hi, wc.max(axis=0))

        data = SceneData(
            tris=tris,
            spheres=spheres,
            materials=materials,
            lights=lights,
            textures=textures,
            background=_t(self.background, dev),
            world_lo=_t(world_lo, dev),
            world_hi=_t(world_hi, dev),
            treelets=treelet_arrays,
            chunks=chunk_arrays,
            bvh=bvh_host.to_device(dev),
        )
        meta = SceneMeta(
            name=self.name,
            n_tris=nt,
            n_spheres=ns,
            n_lights=len(lrows) if self._lights else 0,
            n_materials=len(mats),
            light_types=tuple(int(l["ltype"]) for l in lrows) if self._lights else (),
            material_types=tuple(sorted({int(m["mtype"]) for m in mats})),
            has_sigma=any(
                (float(m["s0"]) != 0.0 or int(m.get("tex1", -1)) >= 0)
                and m["mtype"] == MAT_MATTE
                for m in mats
            ),
            has_textures=any(int(m["tex0"]) >= 0 for m in mats),
            has_sigma_tex=any(int(m.get("tex1", -1)) >= 0 for m in mats),
            slot_mult=slot_mult,
            slot_mult_tight=slot_mult_tight,
            bvh_max_leaf=bvh_host.max_leaf,
            traversal="treelet" if treelet else "dense",
            sphere_mats_untextured=all(
                int(mats[s[4]]["tex0"]) < 0
                and int(mats[s[4]].get("tex1", -1)) < 0
                for s in self._spheres
            ),
            texpool_texels=int(texels.shape[0]),
            texpool_u8_exact=u8_exact,
            texpool_palette=pal_colors,
            n_textures=len(self._textures),
        )
        return Scene(data=data, meta=meta, bvh_host=bvh_host,
                     build_seconds=seconds)
