"""The port's scene loaders (yuki_tpu_torch.scene.ply / pbrt / mitsuba)
against yuki_tpu's: for the repo's scene files, the small atrium and the
cases of tests/test_loaders.py, every scene leaf (tables, BVH) holds the
same bits, SceneMeta, the camera parameters and the film settings are
equal, and parse errors are raised as yuki_tpu raises them."""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_loaders import (MITSUBA_SCENE, PBRT_SCENE, write_ascii_ply,
                          write_binary_ply)
from test_torch_scene import (META_FIELDS, TABLE_LEAVES, _assert_same_bits,
                              _port_leaves)

torch.set_num_threads(2)

SCENES_DIR = Path(__file__).parent.parent / "scenes"


def _pbrt_sigma_texture(tmp):
    from PIL import Image

    img = (np.arange(12).reshape(2, 2, 3) * 20).astype("uint8")
    Image.fromarray(img).save(tmp / "sig.png")
    (tmp / "s.pbrt").write_text(
        'Texture "sig" "spectrum" "imagemap" "string filename" "sig.png"\n'
        'WorldBegin\n'
        'Material "matte" "rgb Kd" [0.5 0.5 0.5] "texture sigma" "sig"\n'
        'Shape "trianglemesh" "integer indices" [0 1 2]\n'
        '  "point P" [0 0 0  1 0 0  0 1 0]\n'
        'WorldEnd\n'
    )
    return tmp / "s.pbrt"


def _pbrt_spectrum(tmp):
    """A sampled spectrum inline and from a .spd file, a matte sigma in
    degrees and a default-copper metal."""
    (tmp / "red.spd").write_text("400 0.1\n500 0.2\n600 0.9\n700 0.95\n")
    (tmp / "s.pbrt").write_text(
        'Camera "perspective" "float fov" [30]\n'
        'WorldBegin\n'
        'Material "matte" "spectrum Kd" [400 0.5 500 0.6 600 0.7 700 0.8]'
        ' "float sigma" [12]\n'
        'Shape "trianglemesh" "integer indices" [0 1 2]\n'
        '  "point P" [0 0 0  1 0 0  0 1 0]\n'
        'Material "matte" "spectrum Kd" "red.spd"\n'
        'Shape "trianglemesh" "integer indices" [0 1 2]\n'
        '  "point P" [0 0 1  1 0 1  0 1 1]\n'
        'Material "metal"\n'
        'Shape "sphere" "float radius" [0.25]\n'
        'WorldEnd\n'
    )
    return tmp / "s.pbrt"


def _pbrt_include(tmp):
    (tmp / "inc.pbrt").write_text(
        'Shape "trianglemesh" "integer indices" [0 1 2] '
        '"point P" [0 0 0 1 0 0 0 1 0]\n'
    )
    (tmp / "main.pbrt").write_text(
        'WorldBegin\nInclude "inc.pbrt"\nWorldEnd\n')
    return tmp / "main.pbrt"


def _pbrt_ply_shape(tmp):
    write_ascii_ply(str(tmp / "m.ply"))
    (tmp / "s.pbrt").write_text(
        'WorldBegin\nShape "plymesh" "string filename" "m.ply"\nWorldEnd\n')
    return tmp / "s.pbrt"


def _written(text, name):
    def make(tmp):
        (tmp / name).write_text(text)
        if name.endswith(".xml"):
            write_ascii_ply(str(tmp / "mesh.ply"))
        return tmp / name
    return make


def _ply(**kw):
    def make(tmp):
        writer = write_binary_ply if "big_endian" in kw else write_ascii_ply
        writer(str(tmp / "t.ply"), **kw)
        return tmp / "t.ply"
    return make


def _small_atrium(tmp):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_atrium_assets import write_scene

    write_scene(str(tmp), small=True)
    return tmp / "atrium.pbrt"


CASES = {
    "cornell.pbrt": lambda tmp: SCENES_DIR / "cornell.pbrt",
    "example.xml": lambda tmp: SCENES_DIR / "example.xml",
    "plane.ply": lambda tmp: SCENES_DIR / "plane.ply",
    "atrium-small": _small_atrium,
    "ply-ascii": _ply(),
    "ply-ascii-normals": _ply(with_normals=True),
    "ply-quad-fan": _ply(quads=True),
    "ply-le": _ply(big_endian=False),
    "ply-be": _ply(big_endian=True),
    "pbrt-scene": _written(PBRT_SCENE, "s.pbrt"),
    "pbrt-include": _pbrt_include,
    "pbrt-ply-shape": _pbrt_ply_shape,
    "pbrt-spectrum": _pbrt_spectrum,
    "pbrt-sigma-texture": _pbrt_sigma_texture,
    "mitsuba-scene": _written(MITSUBA_SCENE, "scene.xml"),
}


def _load_one(path, port):
    """(scene, cam, film) through yuki_tpu's loader for the extension, or
    the port's on the CPU."""
    ext = Path(path).suffix
    if port:
        from yuki_tpu_torch.app.settings import SceneLoadSettings
        from yuki_tpu_torch.scene import mitsuba, pbrt, ply
        kw = {"device": "cpu"}
    else:
        from yuki_tpu.app.settings import SceneLoadSettings
        from yuki_tpu.scene import mitsuba, pbrt, ply
        tp.jax_native_bvh()
        kw = {}
    load = {".pbrt": pbrt.load_pbrt, ".xml": mitsuba.load_mitsuba,
            ".ply": ply.load_ply_scene}[ext]
    return load(SceneLoadSettings(path=str(path)), **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_loaded_scene_matches(tmp_path, case):
    if case == "pbrt-sigma-texture":
        pytest.importorskip("PIL")
    path = CASES[case](tmp_path)
    jscene, jcam, jfilm = _load_one(path, port=False)
    tscene, tcam, tfilm = _load_one(path, port=True)
    ref, got = tp.jax_leaves(jscene), _port_leaves(tscene)
    for name in TABLE_LEAVES:
        _assert_same_bits(ref[name], got[name], name)
    for f in dataclasses.fields(tscene.bvh_host):
        a, b = ref[f"bvh.{f.name}"], getattr(tscene.bvh_host, f.name)
        if isinstance(a, np.ndarray):
            _assert_same_bits(a, b, f"bvh.{f.name}")
        else:
            assert a == b, f.name
    for f in META_FIELDS:
        assert getattr(tscene.meta, f) == getattr(jscene.meta, f), f
    assert dataclasses.asdict(tcam) == dataclasses.asdict(jcam)
    assert dataclasses.asdict(tfilm) == dataclasses.asdict(jfilm)


@pytest.mark.parametrize("case", ["ply-ascii", "ply-ascii-normals",
                                  "ply-quad-fan", "ply-le", "ply-be",
                                  "plane.ply"])
def test_parse_ply_matches(tmp_path, case):
    from yuki_tpu.scene.ply import parse_ply as jparse
    from yuki_tpu_torch.scene.ply import parse_ply

    path = str(CASES[case](tmp_path))
    ref, got = jparse(path), parse_ply(path)
    for f in ("points", "normals", "uvs", "indices"):
        _assert_same_bits(getattr(ref, f), getattr(got, f), f)


def test_sampled_spectrum_matches():
    from yuki_tpu.scene import pbrt as jp
    from yuki_tpu_torch.scene import pbrt

    lam = np.linspace(380, 730, 60)
    for samples in (np.ones_like(lam), np.sin(lam / 40.0) ** 2):
        _assert_same_bits(jp.sampled_spectrum_to_rgb(lam, samples),
                          pbrt.sampled_spectrum_to_rgb(lam, samples), "rgb")
    _assert_same_bits(
        jp.sampled_spectrum_to_rgb(jp.COPPER_WAVELENGTHS, jp.COPPER_K),
        pbrt.sampled_spectrum_to_rgb(pbrt.COPPER_WAVELENGTHS, pbrt.COPPER_K),
        "copper k")


def _bad_ply(tmp):
    p = tmp / "bad.ply"
    p.write_text(
        "ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0\n3 0 0 0\n"
    )
    return p


BAD = {
    "ply-missing-xyz": _bad_ply,
    "mitsuba-wrong-version": _written('<scene version="0.6.0"></scene>',
                                      "bad.xml"),
    "mitsuba-unknown-bsdf": _written(
        '<scene version="2.1.0"><bsdf type="plastic" id="p"/></scene>',
        "bad.xml"),
    "pbrt-unknown-directive": _written("WorldBegin\nFrobnicate 1\n",
                                       "bad.pbrt"),
    "pbrt-missing-texture": _written(
        'WorldBegin\nMaterial "matte" "texture Kd" "nope"\n', "bad.pbrt"),
    "pbrt-orthographic": _written('Camera "orthographic"\n', "bad.pbrt"),
}


@pytest.mark.parametrize("case", list(BAD))
def test_parse_errors_match(tmp_path, case):
    path = BAD[case](tmp_path)
    errors = []
    for port in (False, True):
        with pytest.raises(Exception) as e:
            _load_one(path, port)
        errors.append(e.value)
    assert type(errors[0]).__name__ == type(errors[1]).__name__
    assert str(errors[0]) == str(errors[1])


def test_decoder_matches(tmp_path):
    """decode_image_file on 8-bit RGB, RGBA and greyscale PNGs."""
    from PIL import Image

    from yuki_tpu.textures import decode_image_file as jdecode
    from yuki_tpu_torch.textures import decode_image_file

    rng = np.random.default_rng(3)
    for shape in ((5, 7, 3), (4, 3, 4), (6, 2)):
        p = tmp_path / f"{len(shape)}-{shape[-1]}.png"
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8)).save(p)
        _assert_same_bits(jdecode(str(p)), decode_image_file(str(p)),
                          str(shape))
