"""Mitsuba 2.0 XML scene loading: port of ``yuki_tpu/scene/mitsuba.py``
(yuki/src/scene/mitsuba/ parity).

Same supported subset as the reference: scene version 2.1.0, resx/resy
defaults, perspective sensor with directional fov (sensor.rs), bsdfs
twosided/diffuse/dielectric (material.rs), emitters constant/point/spot
(emitter.rs; area/other emitter types ignored), PLY shapes with bsdf refs
(shape.rs), transform elements rotate/translate/scale/matrix composing
left-to-right (transform.rs).  Mitsuba's +X is to the left of +Z where ours
is to the right, so sensors, spot lights and shapes get the reference's
scale(-1,1,1) handedness fix, point lights flip position.x, and the sensor
rotation is rebuilt as rotation_euler(-x,-y,z) (sensor.rs:72-99).

The reference streams XML; files are small so this uses ElementTree.
Scenes build on the loader's ``device`` (None: the card).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .. import transforms as tf
from ..camera import CameraParameters, FoV
from ..film import FilmSettings
from .data import Scene, SceneBuilder
from .ply import add_ply_mesh

BK7_GLASS_IOR = 1.5046
AIR_IOR = 1.000277


class MitsubaParseError(Exception):
    pass


def _rgb(el, expected_name):
    if el.get("name") != expected_name:
        raise MitsubaParseError(
            f"Expected rgb to be {expected_name!r}, got {el.get('name')!r}"
        )
    vals = [float(v) for v in el.get("value").split()]
    while len(vals) < 3:
        vals.append(vals[-1])
    return np.asarray(vals[:3], dtype=np.float32)


def _parse_transform(el) -> tf.Transform:
    """<transform> children compose left-applied (transform.rs:15-81)."""
    t = tf.Transform.identity()
    for child in el:
        tag = child.tag
        if tag == "rotate":
            axis = np.array(
                [float(child.get(a, 0.0)) for a in ("x", "y", "z")], np.float32
            )
            axis = axis / np.linalg.norm(axis)
            angle = np.radians(float(child.get("angle")))
            t = tf.rotation(angle, axis) @ t
        elif tag == "translate":
            p = [float(v) for v in child.get("value").split()]
            t = tf.translation(p) @ t
        elif tag == "scale":
            p = [float(v) for v in child.get("value").split()]
            if len(p) == 1:
                p = p * 3
            t = tf.scale(*p) @ t
        elif tag == "matrix":
            vals = [float(v) for v in child.get("value").split()]
            t = tf.Transform.from_matrix(np.asarray(vals).reshape(4, 4)) @ t
        else:
            raise MitsubaParseError(f"Unknown transformation data type {tag!r}")
    return t


def _parse_sensor(el) -> tuple[CameraParameters, float | None]:
    fov_axis = ""
    fov_angle = 0.0
    transform = tf.Transform.identity()
    for child in el:
        if child.tag == "string" and child.get("name") == "fov_axis":
            fov_axis = child.get("value")
        elif child.tag == "float" and child.get("name") == "fov":
            fov_angle = float(child.get("value"))
        elif child.tag == "transform":
            transform = _parse_transform(child)
        elif child.tag in ("sampler", "film", "float"):
            continue  # near/far clip etc ignored like the reference
    # Mitsuba's +X is to the left of +Z, ours to the right of it.
    transform = tf.scale(-1.0, 1.0, 1.0) @ transform
    position, euler, scl = transform.decompose()
    if not np.allclose(scl, 1.0, atol=1e-4):
        raise MitsubaParseError("Camera to world has scaling")
    if fov_axis == "x":
        fov = FoV.x(fov_angle)
    elif fov_axis == "y":
        fov = FoV.y(fov_angle)
    else:
        raise MitsubaParseError(f"Unknown fov axis {fov_axis!r}")
    # Compensate for the flipped X axis in the rotation (sensor.rs:98-99).
    c2w = tf.translation(position) @ tf.rotation_euler(
        (-euler[0], -euler[1], euler[2])
    )
    target = c2w.apply_p((0.0, 0.0, 1.0))
    up = c2w.apply_v((0.0, 1.0, 0.0))
    return CameraParameters(
        position=tuple(position), target=tuple(target), up=tuple(up), fov=fov
    )


def _parse_material(b: SceneBuilder, el) -> int:
    btype = el.get("type")
    if btype == "twosided":
        mat = None
        for child in el:
            if child.tag == "bsdf":
                mat = _parse_material(b, child)
            elif child.tag == "rgb":
                mat = b.add_matte(kd=tuple(_rgb(child, "reflectance")))
            else:
                raise MitsubaParseError(
                    f"Unknown material data type {child.tag!r}"
                )
        return mat if mat is not None else b.add_matte(kd=(1.0, 1.0, 1.0))
    if btype == "diffuse":
        kd = (0.5, 0.5, 0.5)
        for child in el:
            if child.tag == "rgb":
                kd = tuple(_rgb(child, "reflectance"))
            else:
                raise MitsubaParseError(f"Unknown light data type {child.tag!r}")
        return b.add_matte(kd=kd)
    if btype == "dielectric":
        int_ior = BK7_GLASS_IOR
        ext_ior = AIR_IOR
        r = (1.0, 1.0, 1.0)
        t = (1.0, 1.0, 1.0)
        for child in el:
            if child.tag == "rgb":
                name = child.get("name")
                if name == "specular_reflectance":
                    r = tuple(_rgb(child, name))
                elif name == "specular_transmittance":
                    t = tuple(_rgb(child, name))
                else:
                    raise MitsubaParseError(
                        f"Unknown dielectric rgb data {name!r}"
                    )
            elif child.tag == "float":
                name = child.get("name")
                val = float(child.get("value"))
                if name == "int_ior":
                    int_ior = val
                elif name == "ext_ior":
                    ext_ior = val
                else:
                    raise MitsubaParseError(
                        f"Unknown dielectric float data {name!r}"
                    )
            else:
                raise MitsubaParseError(
                    f"Unknown dielectric data type {child.tag!r}"
                )
        if abs(ext_ior - AIR_IOR) > 0.001:
            raise MitsubaParseError(
                f"Only air supported for external IoR, got {ext_ior}"
            )
        return b.add_glass(r=r, t=t, eta=int_ior)
    raise MitsubaParseError(f"Unknown bsdf type {btype!r}")


def load_mitsuba(load_settings, device=None
                 ) -> tuple[Scene, CameraParameters, FilmSettings]:
    path = load_settings.path
    dir_path = os.path.dirname(path) or "."
    root = ET.parse(path).getroot()
    if root.tag != "scene":
        raise MitsubaParseError("not a mitsuba scene file")
    if root.get("version") != "2.1.0":
        raise MitsubaParseError("Scene file version is not 2.1.0")

    b = SceneBuilder(os.path.basename(path))
    materials: dict[str, int] = {}
    cam = CameraParameters()
    film = FilmSettings()
    res = list(film.res)

    for el in root:
        tag = el.tag
        if tag == "default":
            name, value = el.get("name"), el.get("value")
            if name == "resx":
                res[0] = int(value)
            elif name == "resy":
                res[1] = int(value)
        elif tag == "integrator":
            continue
        elif tag == "sensor":
            cam = _parse_sensor(el)
        elif tag == "bsdf":
            materials[el.get("id")] = _parse_material(b, el)
        elif tag == "emitter":
            etype = el.get("type")
            if etype == "constant":
                for child in el:
                    if child.tag == "rgb":
                        b.background = _rgb(child, "radiance")
            elif etype == "point":
                pos = np.zeros(3, np.float32)
                intensity = np.zeros(3, np.float32)
                for child in el:
                    if child.tag == "point":
                        if child.get("name") != "position":
                            raise MitsubaParseError("expected position point")
                        for i, a in enumerate(("x", "y", "z")):
                            if child.get(a) is not None:
                                pos[i] = float(child.get(a))
                    elif child.tag == "rgb":
                        intensity = _rgb(child, "intensity")
                pos[0] = -pos[0]  # handedness fix (emitter.rs:106-108)
                b.add_point_light(tf.translation(pos), tuple(intensity))
            elif etype == "spot":
                l2w = tf.Transform.identity()
                intensity = np.zeros(3, np.float32)
                cutoff = 0.0
                beam = 0.0
                for child in el:
                    if child.tag == "float":
                        name = child.get("name")
                        if name == "cutoff_angle":
                            cutoff = float(child.get("value"))
                        elif name == "beam_width":
                            beam = float(child.get("value"))
                        else:
                            raise MitsubaParseError(
                                f"Unexpected spot light float {name!r}"
                            )
                    elif child.tag == "transform":
                        l2w = _parse_transform(child)
                    elif child.tag == "rgb":
                        intensity = _rgb(child, "intensity")
                l2w = tf.scale(-1.0, 1.0, 1.0) @ l2w
                b.add_spot_light(l2w, tuple(intensity), cutoff, beam)
            # other emitter types ignored (emitter.rs:37)
        elif tag == "shape":
            if el.get("type") != "ply":
                raise MitsubaParseError(
                    f"Unexpected shape type {el.get('type')!r}!"
                )
            transform = tf.Transform.identity()
            ply_path = None
            mat_id = None
            for child in el:
                if child.tag == "string":
                    if child.get("name") != "filename":
                        raise MitsubaParseError(
                            "Expected 'filename' string attribute"
                        )
                    ply_path = os.path.join(
                        dir_path, child.get("value").replace("\\", "/")
                    )
                elif child.tag == "ref":
                    if child.get("name") != "bsdf":
                        raise MitsubaParseError("Expected mesh 'ref' to be 'bsdf'")
                    mat_id = child.get("id")
                elif child.tag == "transform":
                    transform = _parse_transform(child)
            transform = tf.scale(-1.0, 1.0, 1.0) @ transform
            if ply_path is None:
                raise MitsubaParseError("Mesh with no ply")
            if mat_id is None:
                raise MitsubaParseError("Mesh with no material")
            if mat_id not in materials:
                raise MitsubaParseError(f"Unknown mesh material {mat_id!r}")
            add_ply_mesh(b, ply_path, transform, materials[mat_id])
        else:
            raise MitsubaParseError(f"Unknown element: {tag!r}")

    scene = b.build(
        split_method=load_settings.split_method_key(),
        max_shapes_in_node=load_settings.max_shapes_in_node,
        device=device,
    )

    # Default target half-way into the visible scene via a bounds probe
    # (mitsuba/mod.rs:193-204).
    pos = np.asarray(cam.position, np.float32)
    fwd = np.asarray(cam.target, np.float32) - pos
    n = np.linalg.norm(fwd)
    if n > 0:
        fwd = fwd / n
        lo, hi = scene.bvh_host.bounds()
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / fwd
            t0 = (lo - pos) * inv
            t1 = (hi - pos) * inv
        tmin = float(np.nanmax(np.fmin(t0, t1)))
        tmax = float(np.nanmin(np.fmax(t0, t1)))
        tmin = max(tmin, 0.0)
        if tmin <= tmax:
            if tmin > 0.0:
                cam.target = tuple(pos + fwd * ((tmin + tmax) / 2.0))
            else:
                cam.target = tuple(pos + fwd * (tmax / 2.0))

    return scene, cam, FilmSettings(res=(res[0], res[1]))
