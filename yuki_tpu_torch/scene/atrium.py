"""The atrium asset: the port's copy of ``tools/make_atrium_assets.py``.

The atrium is the Sponza-class scene that is loaded as an asset: binary
little-endian PLY meshes grouped per material plus a pbrt-v3 scene file,
so the pbrt and PLY loaders and the treelet build run at real-asset scale
(347,136 triangles at the defaults; ``small`` builds a 1,024-triangle
variant for tests).  The geometry is the colonnade's construction
(``testscenes._cylinder``, ``_box``, ``_bumpy_sheet``) with denser
tessellation, baked to world space.  Same inputs, byte-identical files to
the tool's.

``load_atrium`` writes the files on first use under ``scenes/atrium/``
(``scenes/atrium/small/`` for the small variant) and loads them through
``load_pbrt``.
"""

from __future__ import annotations

import os

import numpy as np

from .. import transforms as tf
from .testscenes import _box, _bumpy_sheet, _cylinder

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "scenes",
    "atrium",
)


def _apply(xf: tf.Transform, pts: np.ndarray) -> np.ndarray:
    m = np.asarray(xf.m)
    return pts @ m[:3, :3].T + m[:3, 3]


class Group:
    """World-space triangle soup for one material."""

    def __init__(self):
        self.pts = []
        self.idx = []
        self.base = 0

    def add(self, xf, indices, points):
        points = np.asarray(points, np.float32)
        indices = np.asarray(indices, np.int64).reshape(-1, 3)
        self.pts.append(_apply(xf, points).astype(np.float32))
        self.idx.append(indices + self.base)
        self.base += points.shape[0]

    def arrays(self):
        return np.concatenate(self.pts), np.concatenate(self.idx)


def write_ply(path: str, pts: np.ndarray, tris: np.ndarray):
    """Binary little-endian PLY (positions only; faceted shading, like the
    reference's standalone-PLY default of computed geometric normals)."""
    face = np.zeros(
        len(tris), dtype=np.dtype([("n", "u1"), ("i", "<u4", 3)])
    )
    face["n"] = 3
    face["i"] = tris.astype(np.uint32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(pts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(tris)}\n"
        "property list uchar uint vertex_indices\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(pts.astype("<f4").tobytes())
        f.write(face.tobytes())


def build_groups(columns_x=7, columns_z=4, segments=64, rings=40,
                 drape_res=(72, 96)):
    """Place the atrium geometry into per-material world-space groups."""
    groups = {k: Group() for k in
              ("stone", "floor", "drape_red", "drape_green")}
    ax = 3.0 * (columns_x - 1)
    az = 3.0 * (columns_z - 1)
    H = 9.0

    fp, fi = _box(ax + 8, 0.3, az + 8)
    groups["floor"].add(tf.translation((0, -0.3, 0)), fi, fp)
    groups["stone"].add(tf.translation((0, H, 0)), fi, fp)
    for sx in (-1, 1):
        wp, wi = _box(0.4, H, az + 8)
        groups["stone"].add(tf.translation((sx * (ax / 2 + 3.8), 0, 0)), wi, wp)
    for sz in (-1, 1):
        wp, wi = _box(ax + 8, H, 0.4)
        groups["stone"].add(tf.translation((0, 0, sz * (az / 2 + 3.8))), wi, wp)

    col_pts, col_idx = _cylinder(0.35, 3.6, segments, rings, fluting=0.08)
    cap_pts, cap_idx = _box(1.0, 0.3, 1.0)
    for level in range(2):
        y0 = level * 4.5
        for i in range(columns_x):
            for j in range(columns_z):
                if 0 < i < columns_x - 1 and 0 < j < columns_z - 1:
                    continue
                x = -ax / 2 + 3.0 * i
                z = -az / 2 + 3.0 * j
                groups["stone"].add(
                    tf.translation((x, y0 + 0.3, z)), col_idx, col_pts
                )
                groups["stone"].add(
                    tf.translation((x, y0, z)), cap_idx, cap_pts
                )
                groups["stone"].add(
                    tf.translation((x, y0 + 3.9, z)), cap_idx, cap_pts
                )

    drape_pts, drape_idx = _bumpy_sheet(
        2.4, 3.0, drape_res[0], drape_res[1], 0.18, seed=3
    )
    for i in range(columns_x - 1):
        x = -ax / 2 + 3.0 * i + 1.5
        key = "drape_red" if i % 2 == 0 else "drape_green"
        for sz in (-1, 1):
            groups[key].add(
                tf.translation((x, 6.5, sz * az / 2)) @ tf.rotation_x(np.pi / 2),
                drape_idx, drape_pts,
            )

    spheres = []
    for i in range(columns_x - 1):
        x = -ax / 2 + 3.0 * i + 1.5
        spheres.append(((x, 0.45, 0.0), 0.45))

    cam = dict(
        eye=(-ax / 2 - 2.5, 1.8, 1.5),
        target=(ax / 2, 2.4, 1.5),
        up=(0.0, 1.0, 0.0),
        fov=65.0,
    )
    return groups, spheres, cam, (ax, az, H)


_MATERIALS = """\
MakeNamedMaterial "stone" "string type" "matte"
  "rgb Kd" [0.55 0.52 0.48] "float sigma" [20.0]
MakeNamedMaterial "floor" "string type" "glossy"
  "rgb Ks" [0.3 0.28 0.25] "float roughness" [0.3]
MakeNamedMaterial "drape_red" "string type" "matte" "rgb Kd" [0.45 0.08 0.06]
MakeNamedMaterial "drape_green" "string type" "matte" "rgb Kd" [0.08 0.32 0.10]
MakeNamedMaterial "brass" "string type" "metal"
  "rgb eta" [0.44 0.57 1.33] "rgb k" [3.9 2.45 1.8] "float roughness" [0.1]
"""


def write_scene(out_dir: str, small: bool = False) -> dict:
    """Write out_dir/atrium.pbrt and out_dir/plys/*.ply; returns the
    triangle count of each material group and their "total"."""
    os.makedirs(os.path.join(out_dir, "plys"), exist_ok=True)
    if small:
        groups, spheres, cam, _ = build_groups(
            columns_x=3, columns_z=2, segments=8, rings=2, drape_res=(6, 8)
        )
    else:
        groups, spheres, cam, _ = build_groups()

    counts = {}
    # The header names the generator the files were first made with; it
    # stays so that both generators write the same bytes.
    lines = [
        "# Generated by tools/make_atrium_assets.py — Sponza-class asset",
        "# scene for the yuki-tpu loaders (deterministic; do not hand-edit).",
        "LookAt {} {} {}  {} {} {}  {} {} {}".format(
            *cam["eye"], *cam["target"], *cam["up"]
        ),
        f'Camera "perspective" "float fov" [{cam["fov"]}]',
        'Film "image" "integer xresolution" [1920] "integer yresolution" [1080]',
        "WorldBegin",
        _MATERIALS,
        # Sky through the open skylight + a sun-like key light.
        'LightSource "infinite" "rgb L" [2.5 2.4 2.2]',
        'LightSource "distant" "rgb L" [2.0 1.9 1.7]'
        '  "point from" [0 0 0] "point to" [-0.35 -0.8 -0.2]',
        'LightSource "point" "rgb I" [120 115 105] "point from" [0 8.0 0]',
    ]
    for name, g in groups.items():
        pts, tris = g.arrays()
        counts[name] = len(tris)
        write_ply(os.path.join(out_dir, "plys", f"{name}.ply"), pts, tris)
        lines += [
            "AttributeBegin",
            f'  NamedMaterial "{name}"',
            f'  Shape "plymesh" "string filename" "plys/{name}.ply"',
            "AttributeEnd",
        ]
    for (x, y, z), r in spheres:
        lines += [
            "AttributeBegin",
            '  NamedMaterial "brass"',
            f"  Translate {x} {y} {z}",
            f'  Shape "sphere" "float radius" [{r}]',
            "AttributeEnd",
        ]
    lines.append("WorldEnd")
    with open(os.path.join(out_dir, "atrium.pbrt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    counts["total"] = sum(counts.values())
    return counts


def atrium_dir(small: bool = False) -> str:
    """Where ``load_atrium`` keeps the files."""
    return os.path.join(DEFAULT_DIR, "small") if small else DEFAULT_DIR


def load_atrium(device=None, small: bool = False, out_dir=None):
    """The atrium through the pbrt and PLY loaders on ``device`` (None: the
    card), generated into ``out_dir`` (default ``atrium_dir(small)``) if
    its scene file is not there yet (bench.py:168-187).  Returns
    (scene, camera_params, film_settings)."""
    from ..app.settings import SceneLoadSettings
    from .pbrt import load_pbrt

    root = atrium_dir(small) if out_dir is None else out_dir
    scene_file = os.path.join(root, "atrium.pbrt")
    if not os.path.exists(scene_file):
        write_scene(root, small=small)
    return load_pbrt(SceneLoadSettings(path=scene_file), device=device)
