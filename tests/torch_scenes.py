"""Test scenes built the same way with either package, for the tests that
hold the PyTorch port against the JAX package and for the port's
CUDA-only tests.  Imports neither JAX nor torch: each builder takes the
package's scene.data, transforms and camera modules."""

import numpy as np


def textured_treelet(sd, tf, cam_mod, **build):
    """A textured floor under a holed grid of 5,460 small triangles (a
    treelet scene), a sigma matte, a rect and a distant light."""
    b = sd.SceneBuilder("textured-treelet")
    img = np.random.default_rng(2).integers(0, 256, (16, 16, 3)) / 255.0
    tex = b.add_texture(img.astype(np.float32))
    floor = b.add_matte(kd=(0.5, 0.5, 0.5), kd_tex=tex)
    grey = b.add_matte(kd=(0.6, 0.55, 0.5), sigma=0.3)
    s = 4.0
    b.add_mesh(tf.Transform.identity(), [0, 1, 2, 0, 2, 3],
               [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)],
               uvs=[(0, 0), (4, 0), (4, 4), (0, 4)], material=floor)
    g = 64
    xs = np.linspace(-3.0, 3.0, g + 1, dtype=np.float32)
    pts = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1).reshape(-1, 2)
    pts = np.stack([pts[:, 0], 1.0 + 0.1 * np.sin(3 * pts[:, 0]),
                    pts[:, 1]], -1).astype(np.float32)
    idx = []
    for i in range(g):
        for j in range(g):
            a = i * (g + 1) + j
            if (i + j) % 3 == 0:
                continue  # holes let light through
            idx += [a, a + 1, a + g + 2, a, a + g + 2, a + g + 1]
    b.add_mesh(tf.Transform.identity(), idx, pts, material=grey)
    b.add_rect_light(tf.translation((0.0, 3.0, 0.0)), (20.0, 19.0, 18.0),
                     (2.0, 2.0))
    b.add_distant_light((0.5, 0.5, 0.45), (0.2, 1.0, 0.3))
    cam = cam_mod.CameraParameters(
        position=(0.0, 2.5, 6.0), target=(0.0, 0.3, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(60.0),
    )
    return b.build(**build), cam


# The reduced colonnade of the tests: 24,434 triangles, still a treelet
# scene.
REDUCED = dict(columns_x=3, columns_z=2, segments=8, rings=2)


def row_trap():
    """One hand-made chunk of 16 triangle rows under the box [0, 1]^3 and
    three 128-ray rows of rays along +z from z = -1, for the row-union
    walks' block-level rules.  Triangle 0 is small, around (0.45, 0.45) at
    z = 0.5; triangle 8 (the second group of 8) is large, at z = 0.7,
    reaching outside the box; the rest is padding (prim id -1).  Lane A,
    at x = 0 = the box's lo x, fails every recheck (its x slab is
    0 * inf = NaN) but crosses triangle 8.  Row 0: A (lane 0) and B (lane
    1) at (0.45, 0.45), which crosses both triangles; row 1: A alone
    (lane 128); row 2: A (lane 256) and C (lane 257) at (0.8, 0.8), which
    crosses only triangle 8.  Other lanes are parked (t_max 0); live lanes
    have t_max 5.  Returns numpy (rows [16, 12], chunk bounds [1, 8],
    union words [3, 1] u32, o, d, t_max)."""
    k = 16
    rows = np.zeros((k, 12), np.float32)
    rows[:, 9] = -1.0
    rows[:, 10] = -1.0
    rows[0, :9] = [0.4, 0.4, 0.5, 0.6, 0.4, 0.5, 0.4, 0.6, 0.5]
    rows[8, :9] = [-1.0, -1.0, 0.7, 4.0, -1.0, 0.7, -1.0, 4.0, 0.7]
    rows[[0, 8], 10] = [0.0, 1.0]
    bounds = np.array([[0, 0, 0, 1, 1, 1, 0, 0]], np.float32)
    o = np.tile(np.array([[0.5, 0.5, -1.0]], np.float32), (384, 1))
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (384, 1))
    t_max = np.zeros(384, np.float32)
    for lane, xy in ((0, (0.0, 0.2)), (1, (0.45, 0.45)), (128, (0.0, 0.2)),
                     (256, (0.0, 0.2)), (257, (0.8, 0.8))):
        o[lane, :2] = xy
        t_max[lane] = 5.0
    return rows, bounds, np.ones((3, 1), np.uint32), o, d, t_max
