"""PLY mesh loading: port of ``yuki_tpu/scene/ply.py``.

Supports ascii 1.0 and binary little/big endian 1.0; vertex properties
x,y,z (required) + optional nx,ny,nz,u,v (float/double); faces via
``vertex_index`` or ``vertex_indices`` lists with fan triangulation of
polygons (ply.rs:81-93).  Whole vertex and face blocks decode with numpy
structured dtypes, with the same dtype handling as ``yuki_tpu``, so the
meshes, and the scene tables built from them, hold the same bits.
Standalone PLY scenes get the reference's treatment (scene/mod.rs:99-150):
mesh normalized to a ~1-unit box at the origin, white matte material, a
600 W point light at (5,5,0) and a canned camera at (2,2,2) looking at
the origin with FoV::X(40).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .. import transforms as tf
from ..camera import CameraParameters, FoV
from ..film import FilmSettings
from .data import Scene, SceneBuilder

_TYPE_MAP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyMesh:
    points: np.ndarray  # [V,3] f32
    normals: Optional[np.ndarray]  # [V,3] f32 or None
    uvs: Optional[np.ndarray]  # [V,2] f32 or None
    indices: np.ndarray  # [F*3] triangulated


def parse_ply(path: str) -> PlyMesh:
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---------------------------------------------------------
    end = data.index(b"end_header")
    end = data.index(b"\n", end) + 1
    header = data[:end].decode("ascii", errors="replace")
    lines = [l.strip() for l in header.splitlines() if l.strip()]
    if lines[0] != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements = []  # (name, count, [(prop_name, dtype, is_list, count_dtype)])
    for line in lines[1:]:
        parts = line.split()
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                elements[-1][2].append(
                    (parts[4], _TYPE_MAP[parts[3]], True, _TYPE_MAP[parts[2]])
                )
            else:
                elements[-1][2].append((parts[2], _TYPE_MAP[parts[1]], False, None))
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format {fmt!r}")

    names = {name for name, _, _ in elements}
    if "vertex" not in names or "face" not in names:
        raise ValueError("PLY: missing 'vertex' or 'face' element")

    by_name = {name: (count, props) for name, count, props in elements}
    vprops = [p[0] for p in by_name["vertex"][1]]
    for req in ("x", "y", "z"):
        if req not in vprops:
            raise ValueError(f"PLY: element 'vertex' missing property '{req}'")
    fprops = [p[0] for p in by_name["face"][1]]
    if "vertex_index" not in fprops and "vertex_indices" not in fprops:
        raise ValueError(
            "PLY: element 'face' should have 'vertex_index' or 'vertex_indices'"
        )

    payload = data[end:]
    vert_arrays: dict[str, np.ndarray] = {}
    face_lists: list[np.ndarray] = []

    if fmt == "ascii":
        pos = 0
        text_rows = payload.decode("ascii").split("\n")
        row = 0
        for name, count, props in elements:
            rows = text_rows[row : row + count]
            row += count
            if name == "vertex":
                arr = np.loadtxt(rows, dtype=np.float64, ndmin=2)
                for i, (pname, _, is_list, _) in enumerate(props):
                    if not is_list:
                        vert_arrays[pname] = arr[:, i].astype(np.float32)
            elif name == "face":
                for r in rows:
                    vals = r.split()
                    n = int(vals[0])
                    face_lists.append(np.asarray(vals[1 : 1 + n], dtype=np.int64))
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        pos = 0
        for name, count, props in elements:
            has_list = any(p[2] for p in props)
            if not has_list:
                dt = np.dtype([(p[0], bo + p[1]) for p in props])
                block = np.frombuffer(payload, dtype=dt, count=count, offset=pos)
                pos += dt.itemsize * count
                if name == "vertex":
                    for p in props:
                        vert_arrays[p[0]] = block[p[0]].astype(np.float32)
            else:
                if name != "face":
                    raise ValueError(
                        f"PLY: list properties on unsupported element {name!r}"
                    )
                # Assume uniform list length (true for triangulated/quad
                # exports); verified against the block size, with a python
                # fallback for ragged files.
                lp = next(p for p in props if p[2])
                cdt = np.dtype(bo + lp[3])
                idt = np.dtype(bo + lp[1])
                first_n = int(
                    np.frombuffer(payload, dtype=cdt, count=1, offset=pos)[0]
                )
                stride = cdt.itemsize + first_n * idt.itemsize
                # Fast path: assume every face list has first_n entries
                # (true for triangulated/quad exports), verify, else walk.
                uniform = False
                if pos + stride * count <= len(payload):
                    dt = np.dtype([("n", bo + lp[3]), ("idx", bo + lp[1], first_n)])
                    block = np.frombuffer(payload, dtype=dt, count=count, offset=pos)
                    if bool((block["n"] == first_n).all()):
                        uniform = True
                        pos += dt.itemsize * count
                        face_lists = [block["idx"].astype(np.int64)]
                if not uniform:
                    # Ragged fallback: walk row by row.
                    face_lists = []
                    for _ in range(count):
                        n = int(
                            np.frombuffer(payload, dtype=cdt, count=1, offset=pos)[0]
                        )
                        pos += cdt.itemsize
                        face_lists.append(
                            np.frombuffer(
                                payload, dtype=idt, count=n, offset=pos
                            ).astype(np.int64)
                        )
                        pos += idt.itemsize * n

    points = np.stack(
        [vert_arrays["x"], vert_arrays["y"], vert_arrays["z"]], axis=1
    )
    normals = None
    if all(k in vert_arrays for k in ("nx", "ny", "nz")):
        normals = np.stack(
            [vert_arrays["nx"], vert_arrays["ny"], vert_arrays["nz"]], axis=1
        )
    uvs = None
    if "u" in vert_arrays and "v" in vert_arrays:
        uvs = np.stack([vert_arrays["u"], vert_arrays["v"]], axis=1)

    # Fan-triangulate (ply.rs:81-93).
    if len(face_lists) == 1 and face_lists[0].ndim == 2:
        idx = face_lists[0]
        k = idx.shape[1]
        tris = [
            np.stack([idx[:, 0], idx[:, i], idx[:, i + 1]], axis=1)
            for i in range(1, k - 1)
        ]
        indices = np.concatenate(tris, axis=0).reshape(-1)
    else:
        out = []
        for f in face_lists:
            for i in range(1, len(f) - 1):
                out.extend((f[0], f[i], f[i + 1]))
        indices = np.asarray(out, dtype=np.int64)

    return PlyMesh(points=points, normals=normals, uvs=uvs, indices=indices)


def add_ply_mesh(
    builder: SceneBuilder,
    path: str,
    transform: tf.Transform,
    material: int,
    area_light: int = -1,
) -> PlyMesh:
    """Parse + add to builder with a given transform (pbrt plymesh path)."""
    mesh = parse_ply(path)
    builder.add_mesh(
        transform,
        mesh.indices,
        mesh.points,
        normals=mesh.normals,
        uvs=mesh.uvs,
        material=material,
        area_light=area_light,
    )
    return mesh


def load_ply_scene(load_settings, device=None
                   ) -> tuple[Scene, CameraParameters, FilmSettings]:
    """Standalone PLY scene (Scene::ply, scene/mod.rs:99-150), built on
    ``device`` (None: the card)."""
    import os

    mesh = parse_ply(load_settings.path)
    lo = mesh.points.min(axis=0)
    hi = mesh.points.max(axis=0)
    center = lo + (hi - lo) / 2.0
    mesh_scale = 1.0 / max(float((hi - lo).max()), 1e-20)
    trfn = tf.scale(mesh_scale, mesh_scale, mesh_scale) @ tf.translation(-center)

    b = SceneBuilder(os.path.basename(load_settings.path))
    white = b.add_matte(kd=(1.0, 1.0, 1.0), sigma=0.0)
    b.add_mesh(
        trfn, mesh.indices, mesh.points,
        normals=mesh.normals, uvs=mesh.uvs, material=white,
    )
    b.add_point_light(tf.translation((5.0, 5.0, 0.0)), (600.0, 600.0, 600.0))

    scene = b.build(
        split_method=load_settings.split_method_key(),
        max_shapes_in_node=load_settings.max_shapes_in_node,
        device=device,
    )
    cam = CameraParameters(
        position=(2.0, 2.0, 2.0), target=(0.0, 0.0, 0.0), fov=FoV.x(40.0)
    )
    return scene, cam, FilmSettings()
