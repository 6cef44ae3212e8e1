"""The SPD tetra configuration: Eric Haines's Standard Procedural
Databases ``tetra`` (a recursively subdivided Sierpinski tetrahedron) as
a pbrt-v3 scene file with binary PLY meshes, its generator and its plain
reference.

``write_files`` makes the scene from ``generate`` (the tetrahedron at the
configuration's ``depth``, each leaf written with its own four vertices
as four outward-wound triangles, and a floor quad) into a directory of
the checkout: one binary little-endian PLY per material and the scene
file, each rewritten only when its bytes differ.  ``program_scene`` loads
those files through the program's scene-file entry
(``yuki_tpu_torch.scene.pbrt.load_pbrt``, the call the CLI and the viewer
make).  ``reference_scene`` builds the same scene from the generator's
arrays and the scene file's stated parameters, with nothing taken from
the program.
"""

from __future__ import annotations

import os

import numpy as np

from ..reference.rmath import CameraSpec, translation
from ..reference.scene import RefBuilder

SQRT3 = np.sqrt(3.0)
# SPD tetra.c's base tetrahedron: edge 2, standing on y = 0.
BASE = np.array([[-1.0, 0.0, -1.0 / SQRT3], [1.0, 0.0, -1.0 / SQRT3],
                 [0.0, 0.0, 2.0 / SQRT3], [0.0, 2.0 * np.sqrt(2.0 / 3.0), 0.0]])
FLOOR_Y = -0.001  # off y = 0, so that no face of the tetrahedron lies on it
FLOOR_HALF = 12.0

# The scene file's parameters: (eye, target, up), fov, the lights and the
# materials (name, Kd), in the file's order.
LOOK_AT = ((2.6, 2.1, 3.4), (0.0, 0.6, 0.0), (0.0, 1.0, 0.0))
FOV = 40.0
DISTANT = dict(frm=(0.4, 1.0, 0.3), to=(0.0, 0.0, 0.0), L=(3.0, 3.0, 3.0))
SKY = (0.35, 0.4, 0.5)
MATERIALS = (("tetra", (0.7, 0.7, 0.7)), ("floor", (0.45, 0.45, 0.45)))


def _faces():
    """The four faces of a leaf as local vertex triples, each wound so that
    its normal points away from the vertex it omits.  Every leaf is a
    scaled copy of the base with the base's vertex order, so one winding
    serves all."""
    out = []
    for k in range(4):
        a, b, c = [i for i in range(4) if i != k]
        n = np.cross(BASE[b] - BASE[a], BASE[c] - BASE[a])
        if np.dot(n, BASE[a] - BASE[k]) < 0.0:
            b, c = c, b
        out.append((a, b, c))
    return np.asarray(out, np.int64)


FACES = _faces()


def leaves(depth: int) -> np.ndarray:
    """[4^depth, 4, 3] float64: the leaf tetrahedra.  A tetrahedron
    (v0, v1, v2, v3) is replaced by four, the i-th holding vi and the
    midpoints (vi + vj) / 2 for j != i, in vertex order."""
    tets = BASE[None]
    for _ in range(depth):
        mid = 0.5 * (tets[:, :, None, :] + tets[:, None, :, :])  # [n, i, j, 3]
        tets = mid.reshape(-1, 4, 3)  # child i's vertex j: (vi + vj) / 2
    return tets


def generate(depth: int):
    """{material: (points [V, 3] f32, triangles [F, 3] i64)}: the
    tetrahedron's leaves, each with its own four vertices, and the floor."""
    pts = leaves(depth).astype(np.float32)
    n = pts.shape[0]
    tris = (np.arange(n, dtype=np.int64)[:, None, None] * 4
            + FACES[None]).reshape(-1, 3)
    h = FLOOR_HALF
    floor_p = np.array([[-h, FLOOR_Y, -h], [-h, FLOOR_Y, h], [h, FLOOR_Y, h],
                        [h, FLOOR_Y, -h]], np.float32)
    floor_t = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return {"tetra": (pts.reshape(-1, 3), tris), "floor": (floor_p, floor_t)}


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


def _nums(v) -> str:
    return " ".join(repr(float(x)) for x in v)


def scene_text(cfg: dict) -> str:
    (eye, target, up) = LOOK_AT
    w, h = cfg["res"]
    lines = [
        f"# SPD tetra, size factor {int(cfg['depth'])} "
        "(E. Haines, Standard Procedural Databases).",
        f"LookAt {_nums(eye)}  {_nums(target)}  {_nums(up)}",
        f'Camera "perspective" "float fov" [{FOV!r}]',
        f'Film "image" "integer xresolution" [{int(w)}] '
        f'"integer yresolution" [{int(h)}]',
        "WorldBegin",
        f'LightSource "distant" "point from" [{_nums(DISTANT["frm"])}] '
        f'"point to" [{_nums(DISTANT["to"])}] "rgb L" [{_nums(DISTANT["L"])}]',
        f'LightSource "infinite" "rgb L" [{_nums(SKY)}]',
    ]
    for name, kd in MATERIALS:
        lines.append(f'MakeNamedMaterial "{name}" "string type" "matte" '
                     f'"rgb Kd" [{_nums(kd)}] "float sigma" [0.0]')
    for name, _ in MATERIALS:
        lines += ["AttributeBegin", f'  NamedMaterial "{name}"',
                  f'  Shape "plymesh" "string filename" "plys/{name}.ply"',
                  "AttributeEnd"]
    lines.append("WorldEnd")
    return "\n".join(lines) + "\n"


def _write_if_changed(path: str, data: bytes) -> None:
    if os.path.exists(path):
        with open(path, "rb") as f:
            if f.read() == data:
                return
    with open(path, "wb") as f:
        f.write(data)


def scene_path(work_dir: str) -> str:
    return os.path.join(work_dir, "spd_tetra.pbrt")


def write_files(cfg: dict, work_dir: str):
    """The scene under ``work_dir``; returns the generator's arrays."""
    arrays = generate(int(cfg["depth"]))
    os.makedirs(os.path.join(work_dir, "plys"), exist_ok=True)
    for name, (pts, tris) in arrays.items():
        _write_if_changed(os.path.join(work_dir, "plys", f"{name}.ply"),
                          _ply_bytes(pts, tris))
    _write_if_changed(scene_path(work_dir), scene_text(cfg).encode())
    return arrays


def program_scene(cfg: dict, device, work_dir: str):
    """The scene files loaded by the program's pbrt and PLY loaders; the
    film at the file's resolution, in the configuration's tiles."""
    import sys

    from yuki_tpu_torch.app.settings import SceneLoadSettings
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.scene.pbrt import load_pbrt

    write_files(cfg, work_dir)
    scene, cam, film = load_pbrt(SceneLoadSettings(path=scene_path(work_dir)),
                                 device=device)
    print("spd_tetra: build stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in scene.build_seconds.items()),
        file=sys.stderr)
    return scene, cam, FilmSettings(res=tuple(film.res),
                                    tile_dim=int(cfg["tile_dim"]))


def _f3(v):
    return tuple(np.asarray(v, np.float32))


def reference_scene(cfg: dict, device, dtype, work_dir: str):
    """The scene file's meaning, as pbrt-v3 and yuki's loader state it: a
    default matte first, the named materials in their order (matte sigma
    0), the infinite light as the background, the distant light toward
    from - to, and the camera's fov on the shorter axis."""
    arrays = generate(int(cfg["depth"]))
    b = RefBuilder()
    b.add_matte(kd=(0.5, 0.5, 0.5))
    mats = {name: b.add_matte(kd=_f3(kd), sigma=0.0) for name, kd in MATERIALS}
    b.background = np.asarray(SKY, np.float32)
    w = (np.asarray(DISTANT["frm"], np.float32)
         - np.asarray(DISTANT["to"], np.float32))
    b.add_distant_light(_f3(DISTANT["L"]), w / np.linalg.norm(w))
    ident = translation((0.0, 0.0, 0.0))
    for name, _ in MATERIALS:
        pts, tris = arrays[name]
        b.add_mesh(ident, tris, pts, material=mats[name])
    eye, target, up = (np.asarray(v, np.float32) for v in LOOK_AT)
    spec = CameraSpec(position=tuple(eye), target=tuple(target),
                      up=tuple(up / np.linalg.norm(up)),
                      fov_axis="y" if cfg["res"][1] < cfg["res"][0] else "x",
                      fov_degrees=float(np.float32(FOV)))
    return b.build(device, dtype), spec
