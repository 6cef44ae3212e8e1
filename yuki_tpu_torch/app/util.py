"""Scene load dispatch (app/util.rs:15-63) + EXR helpers (app/util.rs:90-111):
port of ``yuki_tpu/app/util.py``."""

from __future__ import annotations

import logging
import time
from pathlib import Path

from ..camera import CameraParameters
from ..film import FilmSettings
from ..scene.cornell import cornell
from ..scene.data import Scene
from .settings import SceneLoadSettings
from . import exr

log = logging.getLogger("yuki")


def try_load_scene(
    load_settings: SceneLoadSettings, device=None,
) -> tuple[Scene, CameraParameters, FilmSettings, float]:
    """Dispatch by file extension: ply/xml/pbrt; empty path or "cornell"
    -> Cornell box, "colonnade" -> the built-in colonnade
    (app/util.rs:15-63).  The scene builds on ``device`` (None: the card).
    Returns (scene, camera_params, film_settings, load_seconds)."""
    t0 = time.monotonic()
    path = load_settings.path
    if not path or path == "cornell":
        scene, cam, fs = cornell(
            split_method=load_settings.split_method_key(),
            max_shapes_in_node=load_settings.max_shapes_in_node,
            device=device,
        )
        return scene, cam, fs, time.monotonic() - t0
    if path == "colonnade":  # built-in Sponza-class benchmark scene
        from ..scene.testscenes import colonnade

        scene, cam, fs = colonnade(device=device)
        return scene, cam, fs, time.monotonic() - t0

    ext = Path(path).suffix.lower()
    if ext == ".ply":
        from ..scene.ply import load_ply_scene

        scene, cam, fs = load_ply_scene(load_settings, device=device)
    elif ext == ".xml":
        from ..scene.mitsuba import load_mitsuba

        scene, cam, fs = load_mitsuba(load_settings, device=device)
    elif ext == ".pbrt":
        from ..scene.pbrt import load_pbrt

        scene, cam, fs = load_pbrt(load_settings, device=device)
    else:
        raise ValueError(f"unknown scene extension {ext!r}")
    secs = time.monotonic() - t0
    log.info("Scene loaded in %.2fs", secs)
    return scene, cam, fs, secs


def write_exr(path: str, pixels) -> None:
    exr.write_exr(path, pixels)
