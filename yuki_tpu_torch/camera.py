"""Pinhole camera (yuki/src/camera.rs); port of ``yuki_tpu/camera.py``.

The matrices are built on the host exactly like the reference
(perspective camera_to_screen with the mitsuba-style directional FoV
screen window, camera.rs:50-102); ``Camera.ray`` is the batched
Camera::ray (camera.rs:105-115) over film points in torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from . import transforms as tf
from .vecmath import sqrt as _sqrt


@dataclass(frozen=True)
class FoV:
    axis: str  # "x" or "y"
    degrees: float

    @staticmethod
    def x(deg: float) -> "FoV":
        return FoV("x", deg)

    @staticmethod
    def y(deg: float) -> "FoV":
        return FoV("y", deg)


@dataclass
class CameraParameters:
    """CameraParameters (camera.rs:24-41)."""

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    fov: FoV = field(default_factory=lambda: FoV.x(0.0))


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| with no epsilon guard (vecmath.normalize)."""
    length = _sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                        + v[..., 2] * v[..., 2])
    return v / length[..., None]


@dataclass(frozen=True)
class Camera:
    camera_to_world: np.ndarray  # [4,4]
    raster_to_camera: np.ndarray  # [4,4]

    @staticmethod
    def create(params: CameraParameters, res_x: int, res_y: int) -> "Camera":
        camera_to_world = tf.look_at(
            params.position, params.target, params.up
        ).inverted()
        near, far = 1e-2, 1000.0
        inv_tan = 1.0 / np.tan(np.radians(params.fov.degrees) / 2.0)
        persp = tf.Transform.from_matrix(
            [
                [1, 0, 0, 0],
                [0, 1, 0, 0],
                [0, 0, far / (far - near), -(far * near) / (far - near)],
                [0, 0, 1, 0],
            ]
        )
        camera_to_screen = tf.scale(inv_tan, inv_tan, 1.0) @ persp
        fx, fy = float(res_x), float(res_y)
        if params.fov.axis == "x":
            ar = fx / fy
            screen_min = np.array([-1.0, -1.0 / ar], np.float32)
            screen_max = np.array([1.0, 1.0 / ar], np.float32)
        else:
            ar = fy / fx
            screen_min = np.array([-1.0 / ar, -1.0], np.float32)
            screen_max = np.array([1.0 / ar, 1.0], np.float32)
        screen_to_raster = tf.scale(fx, fy, 1.0) @ (
            tf.scale(
                1.0 / (screen_max[0] - screen_min[0]),
                1.0 / (screen_min[1] - screen_max[1]),
                1.0,
            )
            @ tf.translation((-screen_min[0], -screen_max[1], 0.0))
        )
        raster_to_screen = screen_to_raster.inverted()
        raster_to_camera = camera_to_screen.inverted() @ raster_to_screen
        return Camera(
            camera_to_world=camera_to_world.m,
            raster_to_camera=raster_to_camera.m,
        )

    def ray(self, p_film: torch.Tensor):
        """p_film [N,2] raster-space points -> (o [N,3], d [N,3]) world rays
        on p_film's device."""
        dev = p_film.device
        c2w = torch.as_tensor(self.camera_to_world, device=dev)
        r2c = torch.as_tensor(self.raster_to_camera, device=dev)
        p3 = torch.cat(
            [p_film, torch.zeros(p_film.shape[:-1] + (1,), dtype=p_film.dtype,
                                 device=dev)], dim=-1
        )
        p_cam = tf.apply_p(r2c, p3)
        d_world = _normalize(tf.apply_v(c2w, _normalize(p_cam)))
        o_world = c2w[:3, 3].expand(d_world.shape)
        return o_world, d_world
