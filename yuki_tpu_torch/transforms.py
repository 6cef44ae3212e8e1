"""Host-side 4x4 transforms (numpy) + tensor-side application helpers.

Port of ``yuki_tpu/transforms.py``.  Transforms stay on the host as numpy
``float32`` M/M^-1 pairs built exactly like the reference
(``yuki/src/math/{matrix,transform,transforms}.rs``) and are baked into
scene tables at build time; the batched appliers at the bottom are torch
functions over ``[..., 3]`` tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def _mat(rows) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32)


IDENTITY = np.eye(4, dtype=np.float32)


def invert_full_pivot(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion with full pivoting in f32, mirroring
    Matrix4x4::inverted (yuki/src/math/matrix.rs:108-212)."""
    a = m.astype(np.float32).copy()
    inv = np.eye(4, dtype=np.float32)
    row_perm = list(range(4))
    for col in range(4):
        sub = np.abs(a[col:, col:])
        r, c = np.unravel_index(np.argmax(sub), sub.shape)
        r += col
        c += col
        if a[r, c] == 0.0:
            raise np.linalg.LinAlgError("singular matrix")
        if r != col:
            a[[col, r]] = a[[r, col]]
            inv[[col, r]] = inv[[r, col]]
        if c != col:
            a[:, [col, c]] = a[:, [c, col]]
            row_perm[col], row_perm[c] = row_perm[c], row_perm[col]
        pivot = a[col, col]
        a[col] /= pivot
        inv[col] /= pivot
        for rr in range(4):
            if rr != col:
                f = a[rr, col]
                a[rr] -= f * a[col]
                inv[rr] -= f * inv[col]
    # Undo column swaps (they permute the rows of the inverse).
    out = np.empty_like(inv)
    for i, p in enumerate(row_perm):
        out[p] = inv[i]
    return out


@dataclass(frozen=True)
class Transform:
    """An M / M^-1 pair (yuki/src/math/transform.rs)."""

    m: np.ndarray
    m_inv: np.ndarray

    @staticmethod
    def identity() -> "Transform":
        return Transform(IDENTITY, IDENTITY)

    @staticmethod
    def from_matrix(m) -> "Transform":
        m = _mat(m)
        return Transform(m, invert_full_pivot(m))

    def inverted(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __matmul__(self, other: "Transform") -> "Transform":
        return Transform(
            (self.m @ other.m).astype(np.float32),
            (other.m_inv @ self.m_inv).astype(np.float32),
        )

    def apply_p(self, p) -> np.ndarray:
        """Transform a point (projective divide like transform.rs Mul<Point3>)."""
        p = np.asarray(p, dtype=np.float32)
        out = self.m[:3, :3] @ p + self.m[:3, 3]
        w = self.m[3, :3] @ p + self.m[3, 3]
        return (out / w).astype(np.float32) if w != 1.0 else out.astype(np.float32)

    def apply_v(self, v) -> np.ndarray:
        v = np.asarray(v, dtype=np.float32)
        return (self.m[:3, :3] @ v).astype(np.float32)

    def apply_n(self, n) -> np.ndarray:
        """Normals transform by the inverse transpose (transform.rs:148-166)."""
        n = np.asarray(n, dtype=np.float32)
        return (self.m_inv[:3, :3].T @ n).astype(np.float32)

    def swaps_handedness(self) -> bool:
        """det of the upper 3x3 < 0 (transform.rs:88-95)."""
        return bool(np.linalg.det(self.m[:3, :3].astype(np.float64)) < 0.0)

    def decompose(self):
        """TRS + Euler decomposition (matrix.rs:215-262). Returns
        (translation[3], rotation_euler_xyz[3], scale[3])."""
        m = self.m
        t = m[:3, 3].copy()
        s = np.array(
            [
                np.linalg.norm(m[:3, 0]),
                np.linalg.norm(m[:3, 1]),
                np.linalg.norm(m[:3, 2]),
            ],
            dtype=np.float32,
        )
        if np.any(s == 0.0):
            raise ValueError("cannot decompose matrix with zero scale")
        mr = m[:3, :3] / s[None, :]
        theta_x = np.arctan2(mr[1, 2], mr[2, 2])
        c2 = np.sqrt(mr[0, 0] ** 2 + mr[0, 1] ** 2)
        theta_y = np.arctan2(-mr[0, 2], c2)
        s1, c1 = np.sin(theta_x), np.cos(theta_x)
        theta_z = np.arctan2(
            s1 * mr[2, 0] - c1 * mr[1, 0], c1 * mr[1, 1] - s1 * mr[2, 1]
        )
        return t, np.array([theta_x, theta_y, theta_z], dtype=np.float32), s


def translation(delta) -> Transform:
    dx, dy, dz = np.asarray(delta, dtype=np.float32)
    m = _mat([[1, 0, 0, dx], [0, 1, 0, dy], [0, 0, 1, dz], [0, 0, 0, 1]])
    mi = _mat([[1, 0, 0, -dx], [0, 1, 0, -dy], [0, 0, 1, -dz], [0, 0, 0, 1]])
    return Transform(m, mi)


def scale(x, y, z) -> Transform:
    m = _mat([[x, 0, 0, 0], [0, y, 0, 0], [0, 0, z, 0], [0, 0, 0, 1]])
    mi = _mat(
        [[1.0 / x, 0, 0, 0], [0, 1.0 / y, 0, 0], [0, 0, 1.0 / z, 0], [0, 0, 0, 1]]
    )
    return Transform(m, mi)


def rotation_x(theta: float) -> Transform:
    c, s = np.cos(theta), np.sin(theta)
    m = _mat([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])
    return Transform(m, m.T.copy())


def rotation_y(theta: float) -> Transform:
    c, s = np.cos(theta), np.sin(theta)
    m = _mat([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])
    return Transform(m, m.T.copy())


def rotation_z(theta: float) -> Transform:
    c, s = np.cos(theta), np.sin(theta)
    m = _mat([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return Transform(m, m.T.copy())


def rotation(theta: float, axis) -> Transform:
    a = np.asarray(axis, dtype=np.float32)
    a = a / np.linalg.norm(a)
    c, s = np.cos(theta), np.sin(theta)
    x, y, z = a
    m = _mat(
        [
            [x * x + (1 - x * x) * c, x * y * (1 - c) - z * s, x * z * (1 - c) + y * s, 0],
            [x * y * (1 - c) + z * s, y * y + (1 - y * y) * c, y * z * (1 - c) - x * s, 0],
            [x * z * (1 - c) - y * s, y * z * (1 - c) + x * s, z * z + (1 - z * z) * c, 0],
            [0, 0, 0, 1],
        ]
    )
    return Transform(m, m.T.copy())


def rotation_euler(theta) -> Transform:
    tx, ty, tz = np.asarray(theta, dtype=np.float32)
    return rotation_x(tx) @ (rotation_y(ty) @ rotation_z(tz))


def look_at(pos, target, up) -> Transform:
    """World-to-camera transform (transforms.rs:131-153): returns the
    *world_to_camera* pair; ``.inverted()`` gives camera_to_world."""
    pos = np.asarray(pos, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    d = target - pos
    d = d / np.linalg.norm(d)
    upn = up / np.linalg.norm(up)
    right = np.cross(upn, d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    camera_to_world = _mat(
        [
            [right[0], new_up[0], d[0], pos[0]],
            [right[1], new_up[1], d[1], pos[1]],
            [right[2], new_up[2], d[2], pos[2]],
            [0, 0, 0, 1],
        ]
    )
    return Transform(invert_full_pivot(camera_to_world), camera_to_world)


# --- tensor-side batched application -------------------------------------


def _lin(m: torch.Tensor, v: torch.Tensor, i: int) -> torch.Tensor:
    """Row i of the upper 3x3 applied to v [..., 3], summed left to right."""
    return m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1] + m[i, 2] * v[..., 2]


def apply_p(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply a [4,4] matrix to batched points [...,3] with projective divide."""
    out = torch.stack([_lin(m, p, i) + m[i, 3] for i in range(3)], dim=-1)
    w = _lin(m, p, 3) + m[3, 3]
    return out / w[..., None]


def apply_v(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([_lin(m, v, i) for i in range(3)], dim=-1)


def apply_n(m_inv: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Normals by inverse-transpose: pass the *inverse* matrix."""
    return apply_v(m_inv.T, n)
