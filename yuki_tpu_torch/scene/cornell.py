"""Built-in Cornell box scene (yuki/src/scene/mod.rs:154-530); port of
``yuki_tpu/scene/cornell.py`` with the same geometry, materials, light and
back-wall texture.

The reference embeds a 1K tiling basecolor PNG for the back wall.  As in
``yuki_tpu`` (:44-62), the PNG is decoded if it is present under
``res/tiling_58-1K/``; otherwise both packages synthesise the same
deterministic 8-bit tile texture.  The repo does not hold the PNG.
"""

from __future__ import annotations

import math
import os

import numpy as np

from .. import transforms as tf
from ..camera import CameraParameters, FoV
from ..film import FilmSettings
from .data import Scene, SceneBuilder

LEFT = 555.0
RIGHT = 0.0
X_CENTER = (LEFT + RIGHT) / 2.0
BOTTOM = 0.0
TOP = 550.0
FRONT = 0.0
BACK = 560.0
Z_CENTER = (FRONT + BACK) / 2.0
HEIGHT = TOP - BOTTOM
LIGHT_WH = 100.0
LIGHT_HALF_WH = LIGHT_WH / 2.0
LIGHT_FRONT = Z_CENTER - LIGHT_HALF_WH
LIGHT_BACK = Z_CENTER + LIGHT_HALF_WH
LIGHT_LEFT = X_CENTER + LIGHT_HALF_WH
LIGHT_RIGHT = X_CENTER - LIGHT_HALF_WH
HOLE_TOP = TOP + HEIGHT * 0.025

TILING_ASSET = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..",
    "res", "tiling_58-1K", "tiling_58_basecolor-1K.png",
)


def _load_tiling_asset(path: str = None):
    """The real back-wall texture (scene/mod.rs:193-201), decoded from
    ``path`` (default TILING_ASSET) if it exists, else None."""
    path = TILING_ASSET if path is None else path
    if not os.path.exists(path):
        return None
    from ..textures import decode_image_file

    return decode_image_file(path)


def _tiling_texture(size: int = 256) -> np.ndarray:
    """Deterministic stand-in for the tiling_58 basecolor: grey tiles with
    darker grout lines and mild per-tile value variation, quantised to the
    8-bit grid."""
    rng = np.random.default_rng(58)
    tiles = 8
    tile_px = size // tiles
    img = np.zeros((size, size, 3), dtype=np.float32)
    shades = 0.45 + 0.25 * rng.random((tiles, tiles))
    for ty in range(tiles):
        for tx in range(tiles):
            img[ty * tile_px:(ty + 1) * tile_px, tx * tile_px:(tx + 1) * tile_px] = (
                shades[ty, tx]
            )
    # Grout lines.
    for k in range(0, size, tile_px):
        img[max(k - 1, 0):k + 1, :] *= 0.35
        img[:, max(k - 1, 0):k + 1] *= 0.35
    # Slight warm tint like fired tile.
    img *= np.array([1.0, 0.92, 0.85], dtype=np.float32)
    return np.round(np.clip(img, 0.0, 1.0) * 255.0).astype(
        np.float32
    ) / np.float32(255.0)


def cornell(split_method: str = "middle", max_shapes_in_node: int = 1,
            device=None) -> tuple[Scene, CameraParameters, FilmSettings]:
    """The Cornell box on ``device`` (None: default_device()); the BVH
    arguments and their defaults are yuki_tpu's."""
    b = SceneBuilder("Cornell Box")

    handedness_swap = tf.Transform.from_matrix(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]]
    )
    xform = tf.scale(0.001, 0.001, 0.001) @ handedness_swap

    asset = _load_tiling_asset()
    tex = b.add_texture(asset if asset is not None else _tiling_texture())
    white = b.add_matte(kd=(180 / 255.0,) * 3)
    image = b.add_matte(kd=(1.0, 1.0, 1.0), kd_tex=tex)
    red = b.add_matte(kd=(180 / 255.0, 0.0, 0.0))
    green = b.add_matte(kd=(0.0, 180 / 255.0, 0.0))
    blackbody = b.add_matte(kd=(0.0, 0.0, 0.0))
    copper = b.add_metal(
        eta=(0.27105, 0.67693, 1.31640),
        k=(3.60920, 2.62480, 2.29210),
        roughness=0.01,
        remap_roughness=True,
    )
    glass = b.add_glass(r=(1.0, 1.0, 1.0), t=(1.0, 1.0, 1.0), eta=1.5)

    # Rect area light in the ceiling hole (scene/mod.rs:230-240).
    size = (LIGHT_WH / 1000.0, LIGHT_WH / 1000.0)
    area = size[0] * size[1]
    power = 2.0
    radiance = power / (area * math.pi)
    light = b.add_rect_light(
        tf.translation((X_CENTER / 1000.0, HOLE_TOP / 1000.0, -Z_CENTER / 1000.0)),
        (radiance,) * 3,
        size,
    )

    quad = [0, 1, 2, 0, 2, 3]

    # Light geometry (two emissive triangles).
    b.add_mesh(
        xform,
        quad,
        [
            (LIGHT_RIGHT, HOLE_TOP, LIGHT_FRONT),
            (LIGHT_LEFT, HOLE_TOP, LIGHT_FRONT),
            (LIGHT_LEFT, HOLE_TOP, LIGHT_BACK),
            (LIGHT_RIGHT, HOLE_TOP, LIGHT_BACK),
        ],
        material=blackbody,
        area_light=light,
    )

    walls = [
        # (indices, points, material, uvs)
        (quad, [(RIGHT, BOTTOM, BACK), (LEFT, BOTTOM, BACK),
                (LEFT, BOTTOM, FRONT), (RIGHT, BOTTOM, FRONT)], white, None),  # floor
        (quad, [(RIGHT, TOP, FRONT), (LEFT, TOP, FRONT),
                (LEFT, TOP, LIGHT_FRONT), (RIGHT, TOP, LIGHT_FRONT)], white, None),  # ceil front
        (quad, [(RIGHT, TOP, LIGHT_BACK), (LEFT, TOP, LIGHT_BACK),
                (LEFT, TOP, BACK), (RIGHT, TOP, BACK)], white, None),  # ceil back
        (quad, [(LIGHT_LEFT, TOP, FRONT), (LEFT, TOP, FRONT),
                (LEFT, TOP, BACK), (LIGHT_LEFT, TOP, BACK)], white, None),  # ceil left
        (quad, [(RIGHT, TOP, FRONT), (LIGHT_RIGHT, TOP, FRONT),
                (LIGHT_RIGHT, TOP, BACK), (RIGHT, TOP, BACK)], white, None),  # ceil right
        ([0, 2, 1, 0, 3, 2],
         [(LIGHT_RIGHT, HOLE_TOP, LIGHT_FRONT), (LIGHT_LEFT, HOLE_TOP, LIGHT_FRONT),
          (LIGHT_LEFT, TOP, LIGHT_FRONT), (LIGHT_RIGHT, TOP, LIGHT_FRONT)], white, None),  # hole front
        (quad, [(LIGHT_RIGHT, HOLE_TOP, LIGHT_BACK), (LIGHT_LEFT, HOLE_TOP, LIGHT_BACK),
                (LIGHT_LEFT, TOP, LIGHT_BACK), (LIGHT_RIGHT, TOP, LIGHT_BACK)], white, None),  # hole back
        (quad, [(LIGHT_LEFT, TOP, LIGHT_FRONT), (LIGHT_LEFT, TOP, LIGHT_BACK),
                (LIGHT_LEFT, HOLE_TOP, LIGHT_BACK), (LIGHT_LEFT, HOLE_TOP, LIGHT_FRONT)], white, None),  # hole left
        (quad, [(LIGHT_RIGHT, HOLE_TOP, LIGHT_FRONT), (LIGHT_RIGHT, HOLE_TOP, LIGHT_BACK),
                (LIGHT_RIGHT, TOP, LIGHT_BACK), (LIGHT_RIGHT, TOP, LIGHT_FRONT)], white, None),  # hole right
        (quad, [(RIGHT, TOP, BACK), (LEFT, TOP, BACK),
                (LEFT, BOTTOM, BACK), (RIGHT, BOTTOM, BACK)], image,
         [(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)]),  # back wall (textured)
        (quad, [(RIGHT, TOP, FRONT), (RIGHT, TOP, BACK),
                (RIGHT, BOTTOM, BACK), (RIGHT, BOTTOM, FRONT)], green, None),  # right wall
        (quad, [(LEFT, BOTTOM, FRONT), (LEFT, BOTTOM, BACK),
                (LEFT, TOP, BACK), (LEFT, TOP, FRONT)], red, None),  # left wall
    ]
    for indices, pts, mat, uvs in walls:
        b.add_mesh(xform, indices, pts, uvs=uvs, material=mat)

    # Tall glass box (scene/mod.rs:464-495).
    b.add_mesh(
        xform,
        [0, 1, 2, 0, 2, 3, 4, 0, 3, 4, 3, 5, 5, 3, 2, 5, 2, 6,
         6, 2, 1, 6, 1, 7, 7, 1, 0, 7, 0, 4],
        [
            (423.0, 330.0, 247.0),
            (265.0, 330.0, 296.0),
            (314.0, 330.0, 456.0),
            (472.0, 330.0, 406.0),
            (423.0, 0.0, 247.0),
            (472.0, 0.0, 406.0),
            (314.0, 0.0, 456.0),
            (265.0, 0.0, 296.0),
        ],
        material=glass,
    )

    # Copper sphere.
    b.add_sphere(tf.translation((0.186, 0.082, -0.168)), 0.082, copper)

    scene = b.build(split_method=split_method,
                    max_shapes_in_node=max_shapes_in_node, device=device)

    cam = CameraParameters(
        position=(0.278, 0.273, 0.800),
        target=(0.278, 0.273, -0.260),
        fov=FoV.x(40.0),
    )
    return scene, cam, FilmSettings()
