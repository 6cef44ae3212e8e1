"""pbrt-v3 scene loading: port of ``yuki_tpu/scene/pbrt.py``
(yuki/src/scene/pbrt/ parity).

Supports the reference's directive subset (pbrt/mod.rs:486-765):
  Camera "perspective" (fov), Film (x/yresolution), LookAt,
  LightSource infinite/distant/point, Material + MakeNamedMaterial/
  NamedMaterial (glass, glossy, matte, metal), Shape sphere/trianglemesh/
  plymesh, Texture "spectrum" "imagemap", Translate/Rotate/Scale,
  Attribute/Transform blocks, ActiveTransform, Include (file scope stack);
  AreaLightSource/Integrator/Sampler definitions are parsed and ignored.

Sampled-spectrum params ("spectrum" inline or .spd file) convert to RGB via
the Wyman/Sloan/Shirley CIE analytic fits + Riemann sum + XYZ->sRGB matrix
(pbrt/mod.rs:979-1016, pbrt/cie.rs), and metal eta/k default to the
reference's embedded copper tables (pbrt/mod.rs:1027-1105).

Numbers parse as ``yuki_tpu`` parses them (``np.float32(float(tok))``
for float params, the CIE fits in float64), so the tables hold the same
bits.  Scenes build on the loader's ``device`` (None: the card).

Known divergences from the reference, both deliberate (and yuki_tpu's):
  * the reference's TransformEnd pops the *graphics state* stack instead of
    the transform stack (upstream bug, pbrt/mod.rs:747-754); we pop the
    transform stack as pbrt specifies.
  * the reference converts matte "sigma" degrees->radians twice
    (pbrt/mod.rs:905-910); we convert once.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from .. import transforms as tf
from ..camera import CameraParameters, FoV
from ..film import FilmSettings
from ..textures import decode_image_file
from .data import Scene, SceneBuilder


class PbrtParseError(Exception):
    pass


# --- CIE analytic fits (pbrt/cie.rs, Wyman/Sloan/Shirley) ----------------


def x_fit_1931(lam):
    t1 = (lam - 442.0) * np.where(lam < 442.0, 0.0624, 0.0374)
    t2 = (lam - 599.8) * np.where(lam < 599.8, 0.0264, 0.0323)
    t3 = (lam - 501.1) * np.where(lam < 501.1, 0.0490, 0.0382)
    return (
        0.362 * np.exp(-0.5 * t1 * t1)
        + 1.056 * np.exp(-0.5 * t2 * t2)
        - 0.065 * np.exp(-0.5 * t3 * t3)
    )


def y_fit_1931(lam):
    t1 = (lam - 568.8) * np.where(lam < 568.8, 0.0213, 0.0247)
    t2 = (lam - 530.9) * np.where(lam < 530.9, 0.0613, 0.0322)
    return 0.821 * np.exp(-0.5 * t1 * t1) + 0.286 * np.exp(-0.5 * t2 * t2)


def z_fit_1931(lam):
    t1 = (lam - 437.0) * np.where(lam < 437.0, 0.0845, 0.0278)
    t2 = (lam - 459.0) * np.where(lam < 459.0, 0.0385, 0.0725)
    return 1.217 * np.exp(-0.5 * t1 * t1) + 0.681 * np.exp(-0.5 * t2 * t2)


def sampled_spectrum_to_rgb(lam, samples) -> np.ndarray:
    """Riemann sum over CIE fits + XYZ->sRGB (pbrt/mod.rs:979-1016)."""
    lam = np.asarray(lam, dtype=np.float64)
    samples = np.asarray(samples, dtype=np.float64)
    order = np.argsort(lam, kind="stable")
    lam, samples = lam[order], samples[order]
    x = float(np.sum(x_fit_1931(lam) * samples))
    y = float(np.sum(y_fit_1931(lam) * samples))
    z = float(np.sum(z_fit_1931(lam) * samples))
    scale = (lam[-1] - lam[0]) / len(lam)
    x, y, z = x * scale, y * scale, z * scale
    return np.array(
        [
            3.240479 * x - 1.537150 * y - 0.498535 * z,
            -0.969256 * x + 1.875991 * y + 0.041556 * z,
            0.055648 * x - 0.204043 * y + 1.057311 * z,
        ],
        dtype=np.float32,
    )


# Copper spectrum tables (pbrt/mod.rs:1027-1105, originally from pbrt-v3).
COPPER_WAVELENGTHS = np.array([
    298.7570554, 302.4004341, 306.1337728, 309.960445, 313.8839949,
    317.9081487, 322.036826, 326.2741526, 330.6244747, 335.092373,
    339.6826795, 344.4004944, 349.2512056, 354.2405086, 359.374429,
    364.6593471, 370.1020239, 375.7096303, 381.4897785, 387.4505563,
    393.6005651, 399.9489613, 406.5055016, 413.2805933, 420.2853492,
    427.5316483, 435.0322035, 442.8006357, 450.8515564, 459.2006593,
    467.8648226, 476.8622231, 486.2124627, 495.936712, 506.0578694,
    516.6007417, 527.5922468, 539.0616435, 551.0407911, 563.5644455,
    576.6705953, 590.4008476, 604.8008683, 619.92089, 635.8162974,
    652.5483053, 670.1847459, 688.8009889, 708.4810171, 729.3186941,
    751.4192606, 774.9011125, 799.8979226, 826.5611867, 855.0632966,
    885.6012714,
])
COPPER_N = np.array([
    1.400313, 1.38, 1.358438, 1.34, 1.329063, 1.325, 1.3325, 1.34, 1.334375,
    1.325, 1.317812, 1.31, 1.300313, 1.29, 1.281563, 1.27, 1.249062, 1.225,
    1.2, 1.18, 1.174375, 1.175, 1.1775, 1.18, 1.178125, 1.175, 1.172812,
    1.17, 1.165312, 1.16, 1.155312, 1.15, 1.142812, 1.135, 1.131562, 1.12,
    1.092437, 1.04, 0.950375, 0.826, 0.645875, 0.468, 0.35125, 0.272,
    0.230813, 0.214, 0.20925, 0.213, 0.21625, 0.223, 0.2365, 0.25, 0.254188,
    0.26, 0.28, 0.3,
])
COPPER_K = np.array([
    1.662125, 1.687, 1.703313, 1.72, 1.744563, 1.77, 1.791625, 1.81,
    1.822125, 1.834, 1.85175, 1.872, 1.89425, 1.916, 1.931688, 1.95,
    1.972438, 2.015, 2.121562, 2.21, 2.177188, 2.13, 2.160063, 2.21,
    2.249938, 2.289, 2.326, 2.362, 2.397625, 2.433, 2.469187, 2.504,
    2.535875, 2.564, 2.589625, 2.605, 2.595562, 2.583, 2.5765, 2.599,
    2.678062, 2.809, 3.01075, 3.24, 3.458187, 3.67, 3.863125, 4.05,
    4.239563, 4.43, 4.619563, 4.817, 5.034125, 5.26, 5.485625, 5.717,
])


# --- tokenizer (pbrt/lexer.rs role) --------------------------------------

_TOKEN_RE = re.compile(r'"[^"]*"|\[|\]|[^\s"\[\]]+')


def _tokenize(text: str):
    out = []
    for line in text.splitlines():
        hash_pos = line.find("#")
        if hash_pos >= 0:
            line = line[:hash_pos]
        out.extend(_TOKEN_RE.findall(line))
    return out


_DIRECTIVES = {
    "ActiveTransform", "AreaLightSource", "AttributeBegin", "AttributeEnd",
    "Camera", "ConcatTransform", "CoordinateSystem", "CoordSysTransform",
    "Film", "Identity", "Include", "Integrator", "LightSource", "LookAt",
    "MakeNamedMaterial", "Material", "NamedMaterial", "ObjectBegin",
    "ObjectEnd", "ObjectInstance", "PixelFilter", "ReverseOrientation",
    "Rotate", "Sampler", "Scale", "Shape", "Texture", "Transform",
    "TransformBegin", "TransformEnd", "TransformTimes", "Translate",
    "WorldBegin", "WorldEnd", "MediumInterface", "MakeNamedMedium",
    "Accelerator", "All", "StartTime", "EndTime",
}


class _TokenStream:
    def __init__(self, tokens, parent_dir):
        self.tokens = tokens
        self.pos = 0
        self.parent_dir = parent_dir

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise PbrtParseError("unexpected end of file")
        self.pos += 1
        return t

    def string(self) -> str:
        t = self.next()
        if not (t.startswith('"') and t.endswith('"')):
            raise PbrtParseError(f"expected quoted string, got {t!r}")
        return t[1:-1]

    def f32(self) -> float:
        return float(self.next())

    def values(self) -> list:
        """Bracketed list or single value."""
        if self.peek() == "[":
            self.next()
            vals = []
            while self.peek() != "]":
                vals.append(self.next())
            self.next()
            return vals
        return [self.next()]


def _parse_params(ts: _TokenStream) -> dict:
    """Parse '"type name" value...' pairs until the next directive."""
    params = {}
    while True:
        t = ts.peek()
        if t is None or not t.startswith('"'):
            break
        # A param def is a quoted "type name"; a bare quoted string that
        # isn't a known param type belongs to the next directive.
        inner = t[1:-1].split()
        if len(inner) != 2:
            break
        ptype, pname = inner
        if ptype not in (
            "float", "integer", "bool", "string", "rgb", "color",
            "spectrum", "point", "normal", "vector", "texture", "blackbody",
            "point3", "normal3", "point2", "float2", "uv",
        ):
            break
        ts.next()
        raw = ts.values()
        unq = [v[1:-1] if v.startswith('"') else v for v in raw]
        if ptype == "float":
            params[pname] = ("float", np.asarray(unq, dtype=np.float32))
        elif ptype == "integer":
            params[pname] = ("integer", np.asarray(unq, dtype=np.int64))
        elif ptype == "bool":
            params[pname] = ("bool", [v == "true" for v in unq])
        elif ptype in ("string", "texture"):
            params[pname] = (ptype, unq)
        elif ptype in ("rgb", "color"):
            params[pname] = (
                "spectrum", np.asarray(unq, dtype=np.float32).reshape(-1, 3)
            )
        elif ptype == "spectrum":
            if raw and raw[0].startswith('"'):
                # .spd file(s): two columns lambda sample.
                vals = []
                for fname in unq:
                    with open(os.path.join(ts.parent_dir, fname)) as f:
                        for line in f:
                            vals.extend(
                                float(v) for v in line.split()
                            )
                arr = np.asarray(vals, dtype=np.float64).reshape(-1, 2)
            else:
                arr = np.asarray(unq, dtype=np.float64).reshape(-1, 2)
            rgb = sampled_spectrum_to_rgb(arr[:, 0], arr[:, 1])
            params[pname] = ("spectrum", rgb.reshape(1, 3))
        elif ptype in ("point", "point3", "vector"):
            params[pname] = (
                "point", np.asarray(unq, dtype=np.float32).reshape(-1, 3)
            )
        elif ptype in ("normal", "normal3"):
            params[pname] = (
                "normal", np.asarray(unq, dtype=np.float32).reshape(-1, 3)
            )
        elif ptype in ("point2", "float2", "uv"):
            params[pname] = (
                "uv", np.asarray(unq, dtype=np.float32).reshape(-1, 2)
            )
        elif ptype == "blackbody":
            # Reference logs and drops blackbody params (pbrt/mod.rs:452-457)
            pass
    return params


def _find(params, name, ptype, default):
    if name in params and params[name][0] == ptype:
        return params[name][1]
    return default


def _find_scalar(params, name, ptype, default):
    v = _find(params, name, ptype, None)
    if v is None:
        return default
    return v[0] if len(v) else default


def _find_spectrum(params, name, default):
    v = _find(params, name, "spectrum", None)
    if v is None:
        return np.asarray(default, dtype=np.float32)
    return np.asarray(v[0], dtype=np.float32)


class _MaterialTable:
    """Dedups material definitions into builder rows."""

    def __init__(self, builder: SceneBuilder, textures: dict):
        self.b = builder
        self.textures = textures  # name -> builder texture id

    def create(self, mtype: str, params: dict) -> int:
        if mtype == "glass":
            return self.b.add_glass(
                r=tuple(_find_spectrum(params, "Kr", (1, 1, 1))),
                t=tuple(_find_spectrum(params, "Kt", (1, 1, 1))),
                eta=float(_find_scalar(params, "eta", "float", 1.5)),
            )
        if mtype == "glossy":
            return self.b.add_glossy(
                rs=tuple(_find_spectrum(params, "Rs", (0.5, 0.5, 0.5))),
                roughness=float(_find_scalar(params, "roughness", "float", 0.5)),
                remap_roughness=False,
            )
        if mtype == "matte":
            kd_tex = _find_scalar(params, "Kd", "texture", "")
            tex_id = -1
            kd = (0.5, 0.5, 0.5)
            if kd_tex:
                if kd_tex not in self.textures:
                    raise PbrtParseError(f"texture {kd_tex!r} not found")
                tex_id = self.textures[kd_tex]
                kd = (1.0, 1.0, 1.0)
            else:
                kd = tuple(_find_spectrum(params, "Kd", (0.5, 0.5, 0.5)))
            # "texture sigma" binds a Texture<f32> (matte.rs:22-41); the
            # float-texture value is used as-is (radians — the reference's
            # double degrees->radians quirk applies only to constants).
            sigma_name = _find_scalar(params, "sigma", "texture", "")
            sigma_tex = -1
            sigma = 0.0
            if sigma_name:
                if sigma_name not in self.textures:
                    raise PbrtParseError(f"texture {sigma_name!r} not found")
                sigma_tex = self.textures[sigma_name]
            else:
                sigma = float(np.radians(
                    float(_find_scalar(params, "sigma", "float", 0.0))
                ))
            return self.b.add_matte(
                kd=kd, sigma=sigma, kd_tex=tex_id, sigma_tex=sigma_tex
            )
        if mtype == "metal":
            eta = _find_spectrum(
                params, "eta", sampled_spectrum_to_rgb(COPPER_WAVELENGTHS, COPPER_N)
            )
            k = _find_spectrum(
                params, "k", sampled_spectrum_to_rgb(COPPER_WAVELENGTHS, COPPER_K)
            )
            rough = float(_find_scalar(params, "roughness", "float", 0.01))
            remap = bool(_find_scalar(params, "remaproughness", "bool", True))
            return self.b.add_metal(
                eta=tuple(eta), k=tuple(k), roughness=rough, remap_roughness=remap
            )
        # Unsupported -> default matte 0.5 (pbrt/mod.rs:933-939)
        return self.b.add_matte(kd=(0.5, 0.5, 0.5))


def load_pbrt(load_settings, device=None
              ) -> tuple[Scene, CameraParameters, FilmSettings]:
    path = load_settings.path
    builder = SceneBuilder(os.path.basename(path))
    textures: dict[str, int] = {}
    mat_table = _MaterialTable(builder, textures)
    named_materials: dict[str, int] = {}

    default_material = mat_table.create("matte", {})
    cam = CameraParameters(fov=FoV.y(45.0))
    film = FilmSettings()
    res_x, res_y = film.res

    cur_xf = tf.Transform.identity()
    cur_mat = default_material
    active_start = True
    xf_stack: list[tf.Transform] = []
    attr_stack: list[tuple] = []

    def open_scope(p):
        with open(p) as f:
            return _TokenStream(_tokenize(f.read()), os.path.dirname(p) or ".")

    scopes = [open_scope(path)]
    while scopes:
        ts = scopes[-1]
        if ts.peek() is None:
            scopes.pop()
            continue
        tok = ts.next()
        if tok == "ActiveTransform":
            which = ts.next()
            active_start = which in ("All", "StartTime")
        elif tok in ("AreaLightSource", "Integrator", "Sampler", "PixelFilter",
                     "Accelerator", "Film"):
            name = ts.string()
            params = _parse_params(ts)
            if tok == "Film":
                res_x = int(_find_scalar(params, "xresolution", "integer", 640))
                res_y = int(_find_scalar(params, "yresolution", "integer", 480))
            # others parsed and ignored (ignore_type_definition!)
        elif tok == "AttributeBegin":
            attr_stack.append((cur_mat, cur_xf, active_start))
        elif tok == "AttributeEnd":
            if attr_stack:
                cur_mat, cur_xf, active_start = attr_stack.pop()
        elif tok == "Camera":
            name = ts.string()
            if name != "perspective":
                raise PbrtParseError("only perspective camera is supported")
            params = _parse_params(ts)
            cam.fov = FoV.y(float(_find_scalar(params, "fov", "float", 45.0)))
        elif tok == "Include":
            fname = ts.string()
            scopes.append(open_scope(os.path.join(ts.parent_dir, fname)))
        elif tok == "LightSource":
            ltype = ts.string()
            params = _parse_params(ts)
            if ltype == "infinite":
                builder.background = _find_spectrum(params, "L", (1, 1, 1))
            elif ltype == "distant":
                radiance = _find_spectrum(params, "L", (1, 1, 1))
                if radiance.any():
                    frm = np.asarray(
                        _find(params, "from", "point", [[0, 0, 0]])[0], np.float32
                    )
                    to = np.asarray(
                        _find(params, "to", "point", [[0, 0, 1]])[0], np.float32
                    )
                    w = frm - to
                    w = w / np.linalg.norm(w)
                    builder.add_distant_light(tuple(radiance), w)
            elif ltype == "point":
                i = _find_spectrum(params, "I", (1, 1, 1))
                if i.any():
                    pos = np.asarray(
                        _find(params, "from", "point", [[0, 0, 0]])[0], np.float32
                    )
                    builder.add_point_light(tf.translation(pos), tuple(i))
            # others: log-ignore like the reference
        elif tok == "LookAt":
            vals = [ts.f32() for _ in range(9)]
            if active_start:
                cam.position = tuple(vals[0:3])
                cam.target = tuple(vals[3:6])
                up = np.asarray(vals[6:9], np.float32)
                cam.up = tuple(up / np.linalg.norm(up))
        elif tok == "NamedMaterial":
            name = ts.string()
            cur_mat = named_materials.get(name, default_material)
        elif tok == "Material":
            mtype = ts.string()
            cur_mat = mat_table.create(mtype, _parse_params(ts))
        elif tok == "MakeNamedMaterial":
            name = ts.string()
            params = _parse_params(ts)
            mtype = _find_scalar(params, "type", "string", "matte")
            named_materials[name] = mat_table.create(mtype, params)
        elif tok == "Rotate":
            angle = ts.f32()
            axis = (ts.f32(), ts.f32(), ts.f32())
            cur_xf = cur_xf @ tf.rotation(np.radians(angle), axis)
        elif tok == "Scale":
            cur_xf = cur_xf @ tf.scale(ts.f32(), ts.f32(), ts.f32())
        elif tok == "Translate":
            cur_xf = cur_xf @ tf.translation((ts.f32(), ts.f32(), ts.f32()))
        elif tok == "Shape":
            stype = ts.string()
            params = _parse_params(ts)
            if stype == "sphere":
                radius = float(_find_scalar(params, "radius", "float", 1.0))
                builder.add_sphere(cur_xf, radius, cur_mat)
            elif stype == "trianglemesh":
                indices = _find(params, "indices", "integer", np.zeros(0, np.int64))
                if len(indices) < 3 or len(indices) % 3 != 0:
                    continue
                pts = _find(params, "P", "point", np.zeros((0, 3), np.float32))
                nrm = _find(params, "N", "normal", None)
                uv = _find(params, "uv", "uv", None)
                if uv is None:
                    uvf = _find(params, "uv", "float", None)
                    uv = None if uvf is None else np.asarray(uvf).reshape(-1, 2)
                builder.add_mesh(
                    cur_xf, indices, pts, normals=nrm, uvs=uv, material=cur_mat
                )
            elif stype == "plymesh":
                fname = _find_scalar(params, "filename", "string", "")
                if not fname:
                    raise PbrtParseError("empty PLY filename")
                from .ply import add_ply_mesh

                add_ply_mesh(
                    builder,
                    os.path.join(ts.parent_dir, fname),
                    cur_xf,
                    cur_mat,
                )
            # else: log-ignore
        elif tok == "Texture":
            name = ts.string()
            ttype = ts.string()
            tclass = ts.string()
            params = _parse_params(ts)
            if ttype in ("spectrum", "float") and tclass == "imagemap":
                # "float" imagemaps (the type a Texture<f32> sigma binding
                # actually uses in pbrt) register into the same atlas;
                # grayscale data replicates across RGB on decode, matching
                # bsdf.py's channel-0 sigma read.
                fname = _find_scalar(params, "filename", "string", "")
                if not fname:
                    raise PbrtParseError(f"missing file for texture {name!r}")
                img = decode_image_file(os.path.join(ts.parent_dir, fname))
                textures[name] = builder.add_texture(img)
            # else: log-ignore
        elif tok == "TransformBegin":
            xf_stack.append(cur_xf)
        elif tok == "TransformEnd":
            if xf_stack:
                cur_xf = xf_stack.pop()
        elif tok == "WorldBegin":
            cur_xf = tf.Transform.identity()
        elif tok == "WorldEnd":
            pass
        else:
            raise PbrtParseError(f"unimplemented directive {tok!r}")

    # Directional fov by aspect (pbrt/mod.rs:827-836).
    angle = cam.fov.degrees
    cam.fov = FoV.y(angle) if res_y < res_x else FoV.x(angle)

    film = FilmSettings(res=(res_x, res_y))
    scene = builder.build(
        split_method=load_settings.split_method_key(),
        max_shapes_in_node=load_settings.max_shapes_in_node,
        device=device,
    )
    return scene, cam, film
