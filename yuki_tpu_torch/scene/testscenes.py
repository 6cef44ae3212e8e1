"""Procedurally generated benchmark scenes: port of
``yuki_tpu/scene/testscenes.py``.

``colonnade`` builds a deterministic Sponza-class atrium: a floor, two
colonnade levels of fluted columns with capitals, walls, a ceiling with a
rect skylight, a distant sun, brass spheres and draped displaced sheets
(124,478 triangles at the defaults).  Same geometry, materials, lights
and camera as yuki_tpu's, so the two packages build the same tables.
"""

from __future__ import annotations

import numpy as np

from .. import transforms as tf
from ..camera import CameraParameters, FoV
from ..film import FilmSettings
from .data import Scene, SceneBuilder


def _cylinder(radius, height, segments, rings=1, fluting=0.0):
    """Open cylinder mesh (points, indices) along +y, base at origin."""
    ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
    r = radius * (1.0 + fluting * np.cos(ang * 12))
    ys = np.linspace(0, height, rings + 1)
    pts = np.stack(
        [
            np.repeat(ys, segments),
            np.tile(r * np.cos(ang), rings + 1),
            np.tile(r * np.sin(ang), rings + 1),
        ],
        axis=1,
    )[:, [1, 0, 2]]
    idx = []
    for j in range(rings):
        base0 = j * segments
        base1 = (j + 1) * segments
        for i in range(segments):
            a, b = base0 + i, base0 + (i + 1) % segments
            c, d = base1 + i, base1 + (i + 1) % segments
            idx += [a, b, d, a, d, c]
    return pts.astype(np.float32), np.asarray(idx, dtype=np.int64)


def _box(w, h, d):
    x, y, z = w / 2, h, d / 2
    pts = np.array(
        [
            [-x, 0, -z], [x, 0, -z], [x, 0, z], [-x, 0, z],
            [-x, y, -z], [x, y, -z], [x, y, z], [-x, y, z],
        ],
        dtype=np.float32,
    )
    idx = [
        0, 1, 2, 0, 2, 3,  # bottom
        4, 6, 5, 4, 7, 6,  # top
        0, 4, 5, 0, 5, 1,
        1, 5, 6, 1, 6, 2,
        2, 6, 7, 2, 7, 3,
        3, 7, 4, 3, 4, 0,
    ]
    return pts, np.asarray(idx, dtype=np.int64)


def _bumpy_sheet(w, d, nx, nz, amp, seed):
    """Displaced grid sheet in xz at y=0 (curtain / drape stand-in)."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-w / 2, w / 2, nx)
    zs = np.linspace(-d / 2, d / 2, nz)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = amp * (
        np.sin(gx * 3.1) * np.cos(gz * 2.3)
        + 0.5 * rng.standard_normal((nx, nz))
    )
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = []
    for i in range(nx - 1):
        for j in range(nz - 1):
            a = i * nz + j
            b = a + 1
            c = a + nz
            d_ = c + 1
            idx += [a, b, d_, a, d_, c]
    return pts, np.asarray(idx, dtype=np.int64)


def colonnade(
    columns_x: int = 6,
    columns_z: int = 3,
    segments: int = 48,
    rings: int = 24,
    device=None,
) -> tuple[Scene, CameraParameters, FilmSettings]:
    """Sponza-class atrium on ``device`` (None: default_device())."""
    b = SceneBuilder("Colonnade")
    ident = tf.Transform.identity()

    stone = b.add_matte(kd=(0.55, 0.52, 0.48), sigma=np.radians(20.0))
    red_drape = b.add_matte(kd=(0.45, 0.08, 0.06))
    green_drape = b.add_matte(kd=(0.08, 0.32, 0.10))
    floor_mat = b.add_glossy(rs=(0.3, 0.28, 0.25), roughness=0.3,
                             remap_roughness=True)
    brass = b.add_metal(
        eta=(0.44, 0.57, 1.33), k=(3.9, 2.45, 1.8), roughness=0.1,
        remap_roughness=True,
    )

    ax = 3.0 * (columns_x - 1)  # atrium inner extent x
    az = 3.0 * (columns_z - 1)
    H = 9.0  # two levels

    # Floor + ceiling slabs.
    fp, fi = _box(ax + 8, 0.3, az + 8)
    b.add_mesh(tf.translation((0, -0.3, 0)), fi, fp, material=floor_mat)
    cp, ci = _box(ax + 8, 0.3, az + 8)
    b.add_mesh(tf.translation((0, H, 0)), ci, cp, material=stone)

    # Walls (inner surfaces).
    for sx in (-1, 1):
        wp, wi = _box(0.4, H, az + 8)
        b.add_mesh(
            tf.translation((sx * (ax / 2 + 3.8), 0, 0)), wi, wp, material=stone
        )
    for sz in (-1, 1):
        wp, wi = _box(ax + 8, H, 0.4)
        b.add_mesh(
            tf.translation((0, 0, sz * (az / 2 + 3.8))), wi, wp, material=stone
        )

    # Two levels of fluted columns with box capitals/bases.
    col_pts, col_idx = _cylinder(0.35, 3.6, segments, rings, fluting=0.08)
    cap_pts, cap_idx = _box(1.0, 0.3, 1.0)
    for level in range(2):
        y0 = level * 4.5
        for i in range(columns_x):
            for j in range(columns_z):
                if 0 < i < columns_x - 1 and 0 < j < columns_z - 1:
                    continue  # columns only on the perimeter
                x = -ax / 2 + 3.0 * i
                z = -az / 2 + 3.0 * j
                b.add_mesh(
                    tf.translation((x, y0 + 0.3, z)), col_idx, col_pts,
                    material=stone,
                )
                b.add_mesh(
                    tf.translation((x, y0, z)), cap_idx, cap_pts, material=stone
                )
                b.add_mesh(
                    tf.translation((x, y0 + 3.9, z)), cap_idx, cap_pts,
                    material=stone,
                )

    # Hanging drapes between upper columns (high-poly displaced sheets).
    drape_pts, drape_idx = _bumpy_sheet(2.4, 3.0, 48, 64, 0.18, seed=3)
    for i in range(columns_x - 1):
        x = -ax / 2 + 3.0 * i + 1.5
        mat = red_drape if i % 2 == 0 else green_drape
        b.add_mesh(
            tf.translation((x, 6.5, -az / 2)) @ tf.rotation_x(np.pi / 2),
            drape_idx, drape_pts, material=mat,
        )
        b.add_mesh(
            tf.translation((x, 6.5, az / 2)) @ tf.rotation_x(np.pi / 2),
            drape_idx, drape_pts, material=mat,
        )

    # Brass bowls (spheres) down the center line.
    for i in range(columns_x - 1):
        x = -ax / 2 + 3.0 * i + 1.5
        b.add_sphere(tf.translation((x, 0.45, 0.0)), 0.45, brass)

    # Skylight: rect area light in the ceiling.
    light = b.add_rect_light(
        tf.translation((0.0, H - 0.05, 0.0)),
        (40.0, 38.0, 34.0),
        (ax * 0.5, az * 0.5),
    )
    lp = np.array(
        [
            [-ax * 0.25, H - 0.05, -az * 0.25],
            [ax * 0.25, H - 0.05, -az * 0.25],
            [ax * 0.25, H - 0.05, az * 0.25],
            [-ax * 0.25, H - 0.05, az * 0.25],
        ],
        dtype=np.float32,
    )
    black = b.add_matte(kd=(0.0, 0.0, 0.0))
    b.add_mesh(ident, [0, 2, 1, 0, 3, 2], lp, material=black, area_light=light)
    # A sun-like distant light through the skylight.
    b.add_distant_light((2.0, 1.9, 1.7), (0.35, 0.8, 0.2))

    scene = b.build(split_method="sah", max_shapes_in_node=4, device=device)
    # Look down the aisle between column rows (columns sit on z multiples
    # of 3; z=1.5 threads between them).
    cam = CameraParameters(
        position=(-ax / 2 - 2.5, 1.8, 1.5),
        target=(ax / 2, 2.4, 1.5),
        fov=FoV.x(65.0),
    )
    return scene, cam, FilmSettings(res=(1920, 1080))
