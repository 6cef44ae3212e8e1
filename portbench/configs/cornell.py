"""The Cornell box configuration: the program's scene and its plain
reference.

``program_scene`` builds the scene through the program's own entry
(``yuki_tpu_torch.scene.cornell.cornell``).  ``reference_scene`` builds
the same box again from this file's copy of its description (yuki's
scene/mod.rs:154-530: walls, the ceiling hole with its rect light, the
textured back wall with the 8-bit tile stand-in, the glass box and the
copper sphere), with nothing taken from the program.
"""

from __future__ import annotations

import math

import numpy as np

from ..reference.rmath import CameraSpec, matrix, scale, translation
from ..reference.scene import RefBuilder

LEFT, RIGHT = 555.0, 0.0
X_CENTER = (LEFT + RIGHT) / 2.0
BOTTOM, TOP = 0.0, 550.0
FRONT, BACK = 0.0, 560.0
Z_CENTER = (FRONT + BACK) / 2.0
HEIGHT = TOP - BOTTOM
LIGHT_HALF = 50.0
LIGHT_FRONT, LIGHT_BACK = Z_CENTER - LIGHT_HALF, Z_CENTER + LIGHT_HALF
LIGHT_LEFT, LIGHT_RIGHT = X_CENTER + LIGHT_HALF, X_CENTER - LIGHT_HALF
HOLE_TOP = TOP + HEIGHT * 0.025


def program_scene(cfg: dict, device, work_dir: str):
    """(scene, camera parameters, film settings) from the program."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=device)
    return scene, cam, FilmSettings(res=tuple(cfg["res"]),
                                    tile_dim=int(cfg["tile_dim"]))


def tile_texture(size: int = 256) -> np.ndarray:
    """The 8-bit tile stand-in for the back wall's basecolor."""
    rng = np.random.default_rng(58)
    tiles = 8
    tpx = size // tiles
    img = np.zeros((size, size, 3), dtype=np.float32)
    shades = 0.45 + 0.25 * rng.random((tiles, tiles))
    for ty in range(tiles):
        for tx in range(tiles):
            img[ty * tpx:(ty + 1) * tpx, tx * tpx:(tx + 1) * tpx] = shades[ty, tx]
    for k in range(0, size, tpx):
        img[max(k - 1, 0):k + 1, :] *= 0.35
        img[:, max(k - 1, 0):k + 1] *= 0.35
    img *= np.array([1.0, 0.92, 0.85], dtype=np.float32)
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(np.float32) \
        / np.float32(255.0)


def reference_scene(cfg: dict, device, dtype, work_dir: str):
    """(RefScene, CameraSpec) of the box, built from this file alone."""
    b = RefBuilder()
    xform = scale(0.001, 0.001, 0.001) @ matrix(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]])
    tex = b.add_texture(tile_texture())
    white = b.add_matte(kd=(180 / 255.0,) * 3)
    image = b.add_matte(kd=(1.0, 1.0, 1.0), kd_tex=tex)
    red = b.add_matte(kd=(180 / 255.0, 0.0, 0.0))
    green = b.add_matte(kd=(0.0, 180 / 255.0, 0.0))
    black = b.add_matte(kd=(0.0, 0.0, 0.0))
    copper = b.add_metal(eta=(0.27105, 0.67693, 1.31640),
                         k=(3.60920, 2.62480, 2.29210), roughness=0.01,
                         remap=True)
    glass = b.add_glass(r=(1.0, 1.0, 1.0), t=(1.0, 1.0, 1.0), eta=1.5)
    size = (100.0 / 1000.0, 100.0 / 1000.0)
    radiance = 2.0 / (size[0] * size[1] * math.pi)
    light = b.add_rect_light(
        translation((X_CENTER / 1000.0, HOLE_TOP / 1000.0, -Z_CENTER / 1000.0)),
        (radiance,) * 3, size)
    quad = [0, 1, 2, 0, 2, 3]
    b.add_mesh(xform, quad, [(LIGHT_RIGHT, HOLE_TOP, LIGHT_FRONT),
                             (LIGHT_LEFT, HOLE_TOP, LIGHT_FRONT),
                             (LIGHT_LEFT, HOLE_TOP, LIGHT_BACK),
                             (LIGHT_RIGHT, HOLE_TOP, LIGHT_BACK)],
               material=black, area_light=light)
    walls = [
        (quad, [(RIGHT, BOTTOM, BACK), (LEFT, BOTTOM, BACK),
                (LEFT, BOTTOM, FRONT), (RIGHT, BOTTOM, FRONT)], white, None),
        (quad, [(RIGHT, TOP, FRONT), (LEFT, TOP, FRONT),
                (LEFT, TOP, LIGHT_FRONT), (RIGHT, TOP, LIGHT_FRONT)], white, None),
        (quad, [(RIGHT, TOP, LIGHT_BACK), (LEFT, TOP, LIGHT_BACK),
                (LEFT, TOP, BACK), (RIGHT, TOP, BACK)], white, None),
        (quad, [(LIGHT_LEFT, TOP, FRONT), (LEFT, TOP, FRONT),
                (LEFT, TOP, BACK), (LIGHT_LEFT, TOP, BACK)], white, None),
        (quad, [(RIGHT, TOP, FRONT), (LIGHT_RIGHT, TOP, FRONT),
                (LIGHT_RIGHT, TOP, BACK), (RIGHT, TOP, BACK)], white, None),
        ([0, 2, 1, 0, 3, 2],
         [(LIGHT_RIGHT, HOLE_TOP, LIGHT_FRONT), (LIGHT_LEFT, HOLE_TOP, LIGHT_FRONT),
          (LIGHT_LEFT, TOP, LIGHT_FRONT), (LIGHT_RIGHT, TOP, LIGHT_FRONT)],
         white, None),
        (quad, [(LIGHT_RIGHT, HOLE_TOP, LIGHT_BACK), (LIGHT_LEFT, HOLE_TOP, LIGHT_BACK),
                (LIGHT_LEFT, TOP, LIGHT_BACK), (LIGHT_RIGHT, TOP, LIGHT_BACK)],
         white, None),
        (quad, [(LIGHT_LEFT, TOP, LIGHT_FRONT), (LIGHT_LEFT, TOP, LIGHT_BACK),
                (LIGHT_LEFT, HOLE_TOP, LIGHT_BACK), (LIGHT_LEFT, HOLE_TOP, LIGHT_FRONT)],
         white, None),
        (quad, [(LIGHT_RIGHT, HOLE_TOP, LIGHT_FRONT), (LIGHT_RIGHT, HOLE_TOP, LIGHT_BACK),
                (LIGHT_RIGHT, TOP, LIGHT_BACK), (LIGHT_RIGHT, TOP, LIGHT_FRONT)],
         white, None),
        (quad, [(RIGHT, TOP, BACK), (LEFT, TOP, BACK),
                (LEFT, BOTTOM, BACK), (RIGHT, BOTTOM, BACK)], image,
         [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)]),
        (quad, [(RIGHT, TOP, FRONT), (RIGHT, TOP, BACK),
                (RIGHT, BOTTOM, BACK), (RIGHT, BOTTOM, FRONT)], green, None),
        (quad, [(LEFT, BOTTOM, FRONT), (LEFT, BOTTOM, BACK),
                (LEFT, TOP, BACK), (LEFT, TOP, FRONT)], red, None),
    ]
    for idx, pts, mat, uvs in walls:
        b.add_mesh(xform, idx, pts, uvs=uvs, material=mat)
    b.add_mesh(xform,
               [0, 1, 2, 0, 2, 3, 4, 0, 3, 4, 3, 5, 5, 3, 2, 5, 2, 6,
                6, 2, 1, 6, 1, 7, 7, 1, 0, 7, 0, 4],
               [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0),
                (314.0, 330.0, 456.0), (472.0, 330.0, 406.0),
                (423.0, 0.0, 247.0), (472.0, 0.0, 406.0),
                (314.0, 0.0, 456.0), (265.0, 0.0, 296.0)], material=glass)
    b.add_sphere(translation((0.186, 0.082, -0.168)), 0.082, copper)
    cam = CameraSpec(position=(0.278, 0.273, 0.800),
                     target=(0.278, 0.273, -0.260), up=(0.0, 1.0, 0.0),
                     fov_axis="x", fov_degrees=40.0)
    return b.build(device, dtype), cam
