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


def wide_camera(sd, tf, cam_mod, n_tris, n_spheres, seed=0, **build):
    """``n_tris`` random triangles (sides up to ~1.5) 2-6 and
    ``n_spheres`` spheres 4-6 from the origin, on the side that faces (1,
    1, 1), the first of each 2.5 in front of the camera (the triangle
    facing it), a point light, and a camera at the origin looking along
    that diagonal with a 150-degree horizontal field of view: its rays
    take each of x, y and z as their dominant axis, so they span the
    watertight test's three shear frames."""
    rng = np.random.default_rng(seed)
    b = sd.SceneBuilder("wide-camera")
    mat = b.add_matte(kd=(0.6, 0.55, 0.5))

    def shell(n, first, r_min):
        v = rng.standard_normal((n, 3))
        v *= np.where(v.sum(axis=1, keepdims=True) < 0.0, -1.0, 1.0)
        v[:1] = first
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = rng.uniform(r_min, 6.0, (n, 1))
        r[:1] = 2.5
        return v * r

    if n_tris:
        verts = (shell(n_tris, (1.0, 1.0, 1.0), 2.0)[:, None, :]
                 + rng.uniform(-0.75, 0.75, (n_tris, 3, 3))).reshape(-1, 3)
        # The first faces the camera.
        verts[0:3] = 2.5 / np.sqrt(3.0) + np.array(
            [[0.8, -0.8, 0.0], [0.0, 0.8, -0.8], [-0.8, 0.0, 0.8]])
        b.add_mesh(tf.Transform.identity(), list(range(3 * n_tris)),
                   verts.astype(np.float32), material=mat)
    for c in shell(n_spheres, (1.0, 0.0, 0.2), 4.0):
        b.add_sphere(tf.translation(tuple(float(x) for x in c)),
                     float(rng.uniform(0.3, 1.2)), mat)
    b.add_point_light(tf.translation((0.0, 0.5, 0.0)), (5.0, 5.0, 5.0))
    cam = cam_mod.CameraParameters(
        position=(0.0, 0.0, 0.0), target=(1.0, 1.0, 1.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(150.0),
    )
    return b.build(**build), cam


def sun_sphere(sd, tf, cam_mod, **build):
    """A textured sphere (the fused shade gate refuses it: path_li takes
    the shading chain) on a floor beside a glass box, under a distant sun
    and a point light."""
    b = sd.SceneBuilder("sun-sphere")
    img = np.random.default_rng(4).integers(0, 256, (8, 8, 3)) / 255.0
    tex = b.add_texture(img.astype(np.float32))
    floor = b.add_matte(kd=(0.6, 0.6, 0.55), sigma=0.2)
    glass = b.add_glass(r=(1.0, 1.0, 1.0), t=(0.9, 0.95, 1.0), eta=1.5)
    s = 4.0
    b.add_mesh(tf.Transform.identity(), [0, 2, 1, 0, 3, 2],
               [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)],
               material=floor)
    lo, hi = (0.4, 0.0, -0.6), (1.4, 1.0, 0.4)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])],
                       np.float32)
    faces = [0, 1, 3, 0, 3, 2, 4, 6, 7, 4, 7, 5, 0, 4, 5, 0, 5, 1,
             2, 3, 7, 2, 7, 6, 0, 2, 6, 0, 6, 4, 1, 5, 7, 1, 7, 3]
    b.add_mesh(tf.Transform.identity(), faces, corners, material=glass)
    b.add_sphere(tf.translation((-0.9, 0.7, 0.0)), 0.7,
                 b.add_matte(kd=(1.0, 1.0, 1.0), kd_tex=tex))
    b.add_distant_light((1.5, 1.4, 1.3), (0.3, 1.0, 0.4))
    b.add_point_light(tf.translation((0.0, 3.0, 2.0)), (6.0, 6.0, 6.0))
    cam = cam_mod.CameraParameters(
        position=(0.0, 1.8, 5.0), target=(0.0, 0.5, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(50.0),
    )
    return b.build(**build), cam


def lightless(sd, tf, cam_mod, **build):
    """No light at all, a grey-blue sky (the background) over a floor, a
    metal and a glass sphere: path_li's chain adds only the sky."""
    b = sd.SceneBuilder("lightless")
    b.background = np.array([0.4, 0.5, 0.7], np.float32)
    floor = b.add_matte(kd=(0.5, 0.45, 0.4))
    metal = b.add_metal(eta=(0.2, 0.9, 1.1), k=(3.9, 2.4, 2.2),
                        roughness=0.2)
    s = 4.0
    b.add_mesh(tf.Transform.identity(), [0, 2, 1, 0, 3, 2],
               [(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)],
               material=floor)
    b.add_sphere(tf.translation((0.8, 0.5, 0.0)), 0.5, metal)
    b.add_sphere(tf.translation((-0.8, 0.6, 0.2)), 0.6, b.add_glass())
    cam = cam_mod.CameraParameters(
        position=(0.0, 1.5, 4.5), target=(0.0, 0.4, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(55.0),
    )
    return b.build(**build), cam
