"""The atrium configuration: a Sponza-class asset as a pbrt-v3 scene file
with binary PLY meshes, its generator and its plain reference.

``write_files`` makes the asset from this file's frozen copy of the
generator (the colonnade's construction, densely tessellated: 347,136
triangles and 6 brass spheres; an infinite sky, a distant sun and a point
light) into a directory of the checkout, once: a run that finds the same
bytes there writes nothing.  ``program_scene`` loads those files through
the program's pbrt and PLY loaders (``yuki_tpu_torch.scene.atrium.
load_atrium``).  ``reference_scene`` builds the same scene from the
generator's arrays and the scene file's stated parameters, with nothing
taken from the program.
"""

from __future__ import annotations

import os

import numpy as np

from ..reference.rmath import CameraSpec, rotation_x, translation
from ..reference.scene import RefBuilder

MATERIALS = """\
MakeNamedMaterial "stone" "string type" "matte"
  "rgb Kd" [0.55 0.52 0.48] "float sigma" [20.0]
MakeNamedMaterial "floor" "string type" "glossy"
  "rgb Ks" [0.3 0.28 0.25] "float roughness" [0.3]
MakeNamedMaterial "drape_red" "string type" "matte" "rgb Kd" [0.45 0.08 0.06]
MakeNamedMaterial "drape_green" "string type" "matte" "rgb Kd" [0.08 0.32 0.10]
MakeNamedMaterial "brass" "string type" "metal"
  "rgb eta" [0.44 0.57 1.33] "rgb k" [3.9 2.45 1.8] "float roughness" [0.1]
"""


def _cylinder(radius, height, segments, rings=1, fluting=0.0):
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = radius * (1.0 + fluting * np.cos(ang * 12))
    ys = np.linspace(0, height, rings + 1)
    pts = np.stack([np.repeat(ys, segments), np.tile(r * np.cos(ang), rings + 1),
                    np.tile(r * np.sin(ang), rings + 1)], axis=1)[:, [1, 0, 2]]
    idx = []
    for j in range(rings):
        b0, b1 = j * segments, (j + 1) * segments
        for i in range(segments):
            a, b = b0 + i, b0 + (i + 1) % segments
            c, d = b1 + i, b1 + (i + 1) % segments
            idx += [a, b, d, a, d, c]
    return pts.astype(np.float32), np.asarray(idx, dtype=np.int64)


def _box(w, h, d):
    x, y, z = w / 2, h, d / 2
    pts = np.array([[-x, 0, -z], [x, 0, -z], [x, 0, z], [-x, 0, z],
                    [-x, y, -z], [x, y, -z], [x, y, z], [-x, y, z]],
                   dtype=np.float32)
    idx = [0, 1, 2, 0, 2, 3, 4, 6, 5, 4, 7, 6, 0, 4, 5, 0, 5, 1,
           1, 5, 6, 1, 6, 2, 2, 6, 7, 2, 7, 3, 3, 7, 4, 3, 4, 0]
    return pts, np.asarray(idx, dtype=np.int64)


def _bumpy_sheet(w, d, nx, nz, amp, seed):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-w / 2, w / 2, nx)
    zs = np.linspace(-d / 2, d / 2, nz)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = amp * (np.sin(gx * 3.1) * np.cos(gz * 2.3)
                + 0.5 * rng.standard_normal((nx, nz)))
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            a = i * nz + j
            c = a + nz
            idx += [a, a + 1, c + 1, a, c + 1, c]
    return pts, np.asarray(idx, dtype=np.int64)


class _Group:
    def __init__(self):
        self.pts, self.idx, self.base = [], [], 0

    def add(self, xf, indices, points):
        points = np.asarray(points, np.float32)
        m = np.asarray(xf.m)
        self.pts.append((points @ m[:3, :3].T + m[:3, 3]).astype(np.float32))
        self.idx.append(np.asarray(indices, np.int64).reshape(-1, 3) + self.base)
        self.base += points.shape[0]

    def arrays(self):
        return np.concatenate(self.pts), np.concatenate(self.idx)


def build_groups(columns_x=7, columns_z=4, segments=64, rings=40,
                 drape_res=(72, 96)):
    """Per-material world-space groups, the spheres and the camera."""
    groups = {k: _Group() for k in ("stone", "floor", "drape_red",
                                    "drape_green")}
    ax, az, height = 3.0 * (columns_x - 1), 3.0 * (columns_z - 1), 9.0
    fp, fi = _box(ax + 8, 0.3, az + 8)
    groups["floor"].add(translation((0, -0.3, 0)), fi, fp)
    groups["stone"].add(translation((0, height, 0)), fi, fp)
    for sx in (-1, 1):
        wp, wi = _box(0.4, height, az + 8)
        groups["stone"].add(translation((sx * (ax / 2 + 3.8), 0, 0)), wi, wp)
    for sz in (-1, 1):
        wp, wi = _box(ax + 8, height, 0.4)
        groups["stone"].add(translation((0, 0, sz * (az / 2 + 3.8))), wi, wp)
    col_p, col_i = _cylinder(0.35, 3.6, segments, rings, fluting=0.08)
    cap_p, cap_i = _box(1.0, 0.3, 1.0)
    for level in range(2):
        y0 = level * 4.5
        for i in range(columns_x):
            for j in range(columns_z):
                if 0 < i < columns_x - 1 and 0 < j < columns_z - 1:
                    continue
                x, z = -ax / 2 + 3.0 * i, -az / 2 + 3.0 * j
                groups["stone"].add(translation((x, y0 + 0.3, z)), col_i, col_p)
                groups["stone"].add(translation((x, y0, z)), cap_i, cap_p)
                groups["stone"].add(translation((x, y0 + 3.9, z)), cap_i, cap_p)
    dp, di = _bumpy_sheet(2.4, 3.0, drape_res[0], drape_res[1], 0.18, seed=3)
    for i in range(columns_x - 1):
        x = -ax / 2 + 3.0 * i + 1.5
        key = "drape_red" if i % 2 == 0 else "drape_green"
        for sz in (-1, 1):
            groups[key].add(translation((x, 6.5, sz * az / 2))
                            @ rotation_x(np.pi / 2), di, dp)
    spheres = [((-ax / 2 + 3.0 * i + 1.5, 0.45, 0.0), 0.45)
               for i in range(columns_x - 1)]
    cam = dict(eye=(-ax / 2 - 2.5, 1.8, 1.5), target=(ax / 2, 2.4, 1.5),
               up=(0.0, 1.0, 0.0), fov=65.0)
    return groups, spheres, cam


def _ply_bytes(pts, tris) -> bytes:
    face = np.zeros(len(tris), dtype=np.dtype([("n", "u1"), ("i", "<u4", 3)]))
    face["n"] = 3
    face["i"] = tris.astype(np.uint32)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\n"
              f"element face {len(tris)}\n"
              "property list uchar uint vertex_indices\nend_header\n")
    return header.encode() + pts.astype("<f4").tobytes() + face.tobytes()


def _scene_text(groups, spheres, cam) -> str:
    lines = [
        "# Generated by tools/make_atrium_assets.py — Sponza-class asset",
        "# scene for the yuki-tpu loaders (deterministic; do not hand-edit).",
        "LookAt {} {} {}  {} {} {}  {} {} {}".format(
            *cam["eye"], *cam["target"], *cam["up"]),
        f'Camera "perspective" "float fov" [{cam["fov"]}]',
        'Film "image" "integer xresolution" [1920] "integer yresolution" [1080]',
        "WorldBegin",
        MATERIALS,
        'LightSource "infinite" "rgb L" [2.5 2.4 2.2]',
        'LightSource "distant" "rgb L" [2.0 1.9 1.7]'
        '  "point from" [0 0 0] "point to" [-0.35 -0.8 -0.2]',
        'LightSource "point" "rgb I" [120 115 105] "point from" [0 8.0 0]',
    ]
    for name in groups:
        lines += ["AttributeBegin", f'  NamedMaterial "{name}"',
                  f'  Shape "plymesh" "string filename" "plys/{name}.ply"',
                  "AttributeEnd"]
    for (x, y, z), r in spheres:
        lines += ["AttributeBegin", '  NamedMaterial "brass"',
                  f"  Translate {x} {y} {z}",
                  f'  Shape "sphere" "float radius" [{r}]', "AttributeEnd"]
    lines.append("WorldEnd")
    return "\n".join(lines) + "\n"


def _generate(cfg: dict):
    kw = cfg.get("generator", {})
    groups, spheres, cam = build_groups(**kw)
    arrays = {k: g.arrays() for k, g in groups.items()}
    return arrays, spheres, cam


def _write_if_changed(path: str, data: bytes) -> None:
    if os.path.exists(path):
        with open(path, "rb") as f:
            if f.read() == data:
                return
    with open(path, "wb") as f:
        f.write(data)


def write_files(cfg: dict, work_dir: str):
    """The asset under ``work_dir``; returns the generator's arrays."""
    arrays, spheres, cam = _generate(cfg)
    os.makedirs(os.path.join(work_dir, "plys"), exist_ok=True)
    for name, (pts, tris) in arrays.items():
        _write_if_changed(os.path.join(work_dir, "plys", f"{name}.ply"),
                          _ply_bytes(pts, tris))
    _write_if_changed(os.path.join(work_dir, "atrium.pbrt"),
                      _scene_text(arrays, spheres, cam).encode())
    return arrays, spheres, cam


def program_scene(cfg: dict, device, work_dir: str):
    """The asset loaded by the program's pbrt and PLY loaders."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.scene.atrium import load_atrium

    write_files(cfg, work_dir)
    scene, cam, _ = load_atrium(device=device, out_dir=work_dir)
    return scene, cam, FilmSettings(res=tuple(cfg["res"]),
                                    tile_dim=int(cfg["tile_dim"]))


def _f32(x) -> float:
    return float(np.float32(x))


def reference_scene(cfg: dict, device, dtype, work_dir: str):
    """The scene file's meaning, as pbrt-v3 and yuki's loader state it:
    a default matte first, the named materials in their order (matte
    sigma in degrees to radians; glossy reads "Rs", so the file's "Ks"
    leaves it at 0.5, unremapped; metal remaps its roughness), the
    infinite light as the background, the distant light toward from - to,
    and the camera's fov on the shorter axis."""
    arrays, spheres, cam = _generate(cfg)
    b = RefBuilder()
    b.add_matte(kd=(0.5, 0.5, 0.5))
    f3 = lambda *v: tuple(np.asarray(v, np.float32))
    mats = {
        "stone": b.add_matte(kd=f3(0.55, 0.52, 0.48),
                             sigma=float(np.radians(_f32(20.0)))),
        "floor": b.add_glossy(rs=(0.5, 0.5, 0.5), roughness=_f32(0.3),
                              remap=False),
        "drape_red": b.add_matte(kd=f3(0.45, 0.08, 0.06)),
        "drape_green": b.add_matte(kd=f3(0.08, 0.32, 0.10)),
        "brass": b.add_metal(eta=f3(0.44, 0.57, 1.33), k=f3(3.9, 2.45, 1.8),
                             roughness=_f32(0.1), remap=True),
    }
    b.background = np.asarray([2.5, 2.4, 2.2], np.float32)
    w = np.asarray([0, 0, 0], np.float32) - np.asarray([-0.35, -0.8, -0.2],
                                                       np.float32)
    b.add_distant_light(f3(2.0, 1.9, 1.7), w / np.linalg.norm(w))
    b.add_point_light((0.0, 8.0, 0.0), f3(120, 115, 105))
    ident = translation((0.0, 0.0, 0.0))
    for name, (pts, tris) in arrays.items():
        b.add_mesh(ident, tris, pts, material=mats[name])
    for (x, y, z), r in spheres:
        b.add_sphere(translation((_f32(x), _f32(y), _f32(z))), _f32(r),
                     mats["brass"])
    up = np.asarray(cam["up"], np.float32)
    spec = CameraSpec(position=tuple(np.float32(v) for v in cam["eye"]),
                      target=tuple(np.float32(v) for v in cam["target"]),
                      up=tuple(up / np.linalg.norm(up)),
                      fov_axis="y" if cfg["res"][1] < cfg["res"][0] else "x",
                      fov_degrees=_f32(cam["fov"]))
    return b.build(device, dtype), spec
