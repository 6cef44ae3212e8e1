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
