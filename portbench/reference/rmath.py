"""Plain maths of the reference renderer: vectors, host transforms, the
pinhole camera and the counter-based samplers.

A frozen copy of the semantics yuki's renderer states (the pbrt-style
camera, the PCG-hashed sampler dimensions, Kensler's permutation for the
stratified sampler), written in plain PyTorch and numpy.  Nothing here
imports the program under test.  Every function follows the dtype of the
tensors it is given, so the same code runs the reference in float32 and
its lower-precision control in bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


# --- vectors ------------------------------------------------------------------


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root in x's dtype (via float64)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A scalar tensor of like's dtype and device, to divide by (a tensor
    divisor keeps the IEEE divide on CUDA)."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def recip(x: torch.Tensor) -> torch.Tensor:
    return const(1.0, x) / x


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return sqrt(dot(a, a))


def normalize_safe(a, eps: float = 1e-20):
    return a / torch.clamp(length(a), min=eps)[..., None]


def face_forward(n, v):
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v):
    """Orthonormal basis around the unit v (pbrt-v3's, with the y/z root)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = recip(sqrt(torch.where(use_x, x * x + z * z, y * y + z * z)))
    zeros = torch.zeros_like(x)
    v1 = torch.where(use_x[..., None], torch.stack([-z, zeros, x], dim=-1),
                     torch.stack([zeros, z, -y], dim=-1)) * inv_a[..., None]
    return v1, cross(v, v1)


def is_black(s):
    return torch.all(s == 0.0, dim=-1)


def apply_p(m, p):
    """A [4,4] matrix on points [...,3], projective divide."""
    lin = lambda i: m[i, 0] * p[..., 0] + m[i, 1] * p[..., 1] + m[i, 2] * p[..., 2]
    out = torch.stack([lin(i) + m[i, 3] for i in range(3)], dim=-1)
    return out / (lin(3) + m[3, 3])[..., None]


def apply_v(m, v):
    return torch.stack([m[i, 0] * v[..., 0] + m[i, 1] * v[..., 1]
                        + m[i, 2] * v[..., 2] for i in range(3)], dim=-1)


# --- host transforms (float32 M / M^-1 pairs) ------------------------------------


def _mat(rows):
    return np.asarray(rows, dtype=np.float32)


def invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion with full pivoting in float32."""
    a = m.astype(np.float32).copy()
    inv = np.eye(4, dtype=np.float32)
    perm = list(range(4))
    for col in range(4):
        sub = np.abs(a[col:, col:])
        r, c = np.unravel_index(np.argmax(sub), sub.shape)
        r += col
        c += col
        if r != col:
            a[[col, r]] = a[[r, col]]
            inv[[col, r]] = inv[[r, col]]
        if c != col:
            a[:, [col, c]] = a[:, [c, col]]
            perm[col], perm[c] = perm[c], perm[col]
        piv = a[col, col]
        a[col] /= piv
        inv[col] /= piv
        for rr in range(4):
            if rr != col:
                f = a[rr, col]
                a[rr] -= f * a[col]
                inv[rr] -= f * inv[col]
    out = np.empty_like(inv)
    for i, p in enumerate(perm):
        out[p] = inv[i]
    return out


@dataclass(frozen=True)
class Xf:
    m: np.ndarray
    m_inv: np.ndarray

    def __matmul__(self, o: "Xf") -> "Xf":
        return Xf((self.m @ o.m).astype(np.float32),
                  (o.m_inv @ self.m_inv).astype(np.float32))

    def apply_p(self, p) -> np.ndarray:
        p = np.asarray(p, dtype=np.float32)
        out = self.m[:3, :3] @ p + self.m[:3, 3]
        w = self.m[3, :3] @ p + self.m[3, 3]
        return (out / w).astype(np.float32) if w != 1.0 else out.astype(np.float32)

    def swaps_handedness(self) -> bool:
        return bool(np.linalg.det(self.m[:3, :3].astype(np.float64)) < 0.0)


IDENTITY = Xf(np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32))


def matrix(rows) -> Xf:
    m = _mat(rows)
    return Xf(m, invert(m))


def translation(delta) -> Xf:
    dx, dy, dz = np.asarray(delta, dtype=np.float32)
    return Xf(_mat([[1, 0, 0, dx], [0, 1, 0, dy], [0, 0, 1, dz], [0, 0, 0, 1]]),
              _mat([[1, 0, 0, -dx], [0, 1, 0, -dy], [0, 0, 1, -dz],
                    [0, 0, 0, 1]]))


def scale(x, y, z) -> Xf:
    return Xf(_mat([[x, 0, 0, 0], [0, y, 0, 0], [0, 0, z, 0], [0, 0, 0, 1]]),
              _mat([[1.0 / x, 0, 0, 0], [0, 1.0 / y, 0, 0], [0, 0, 1.0 / z, 0],
                    [0, 0, 0, 1]]))


def rotation_x(theta: float) -> Xf:
    c, s = np.cos(theta), np.sin(theta)
    m = _mat([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])
    return Xf(m, m.T.copy())


def look_at_camera_to_world(pos, target, up) -> np.ndarray:
    pos = np.asarray(pos, dtype=np.float32)
    target = np.asarray(target, dtype=np.float32)
    up = np.asarray(up, dtype=np.float32)
    d = target - pos
    d = d / np.linalg.norm(d)
    upn = up / np.linalg.norm(up)
    right = np.cross(upn, d)
    right = right / np.linalg.norm(right)
    new_up = np.cross(d, right)
    return _mat([[right[0], new_up[0], d[0], pos[0]],
                 [right[1], new_up[1], d[1], pos[1]],
                 [right[2], new_up[2], d[2], pos[2]], [0, 0, 0, 1]])


# --- pinhole camera ---------------------------------------------------------------


@dataclass(frozen=True)
class CameraSpec:
    position: tuple
    target: tuple
    up: tuple
    fov_axis: str  # "x" or "y"
    fov_degrees: float


def camera_matrices(cam: CameraSpec, res_x: int, res_y: int):
    """(camera_to_world, raster_to_camera) as float32 [4,4] numpy."""
    c2w = look_at_camera_to_world(cam.position, cam.target, cam.up)
    near, far = 1e-2, 1000.0
    inv_tan = 1.0 / np.tan(np.radians(cam.fov_degrees) / 2.0)
    persp = matrix([[1, 0, 0, 0], [0, 1, 0, 0],
                    [0, 0, far / (far - near), -(far * near) / (far - near)],
                    [0, 0, 1, 0]])
    cam_to_screen = scale(inv_tan, inv_tan, 1.0) @ persp
    fx, fy = float(res_x), float(res_y)
    if cam.fov_axis == "x":
        ar = fx / fy
        smin = np.array([-1.0, -1.0 / ar], np.float32)
        smax = np.array([1.0, 1.0 / ar], np.float32)
    else:
        ar = fy / fx
        smin = np.array([-1.0 / ar, -1.0], np.float32)
        smax = np.array([1.0 / ar, 1.0], np.float32)
    screen_to_raster = scale(fx, fy, 1.0) @ (
        scale(1.0 / (smax[0] - smin[0]), 1.0 / (smin[1] - smax[1]), 1.0)
        @ translation((-smin[0], -smax[1], 0.0)))
    raster_to_screen = Xf(screen_to_raster.m_inv, screen_to_raster.m)
    cam_to_screen_inv = Xf(cam_to_screen.m_inv, cam_to_screen.m)
    raster_to_camera = cam_to_screen_inv @ raster_to_screen
    return c2w, raster_to_camera.m


def camera_rays(c2w: torch.Tensor, r2c: torch.Tensor, p_film: torch.Tensor):
    """Film points [N,2] -> world rays (o, d) [N,3]."""
    zeros = torch.zeros(p_film.shape[:-1] + (1,), dtype=p_film.dtype,
                        device=p_film.device)
    p_cam = apply_p(r2c, torch.cat([p_film, zeros], dim=-1))
    nrm = lambda v: v / sqrt(dot(v, v))[..., None]
    d = nrm(apply_v(c2w, nrm(p_cam)))
    return c2w[:3, 3].expand(d.shape), d


# --- samplers -----------------------------------------------------------------------


def _u32(x, device=None) -> torch.Tensor:
    if isinstance(x, int):
        return torch.tensor(x & MASK32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def pcg_hash(x) -> torch.Tensor:
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def hash_key(*vals) -> torch.Tensor:
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
    h = _u32(GOLDEN, dev)
    for v in vals:
        h = pcg_hash(h ^ _u32(v, dev))
    return h


def _mul32(a, b: int):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def unit_float(u: torch.Tensor, dtype) -> torch.Tensor:
    """u32 -> [0,1): 24 high bits / 2^24, then rounded to dtype."""
    return ((u >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


@dataclass(frozen=True)
class Lanes:
    """The sampler key of each lane."""

    px: torch.Tensor  # [N] int64
    py: torch.Tensor
    sample_index: int
    seed: int

    def pixel_hash(self):
        return hash_key(self.seed, ((_u32(self.px) << 16) & MASK32)
                        | _u32(self.py))

    def dim_u32(self, dim: int):
        ph = self.pixel_hash()
        return pcg_hash(pcg_hash(ph ^ _u32(self.sample_index, ph.device))
                        ^ _u32(dim, ph.device))


def permutation_element(i, l: int, p: torch.Tensor) -> torch.Tensor:
    """Kensler's hashed permutation of i in [0, l) keyed by the u32 p;
    a rejected lane re-runs the round on its own output."""
    w = l - 1
    for s in (1, 2, 4, 8, 16):
        w |= w >> s
    p = _u32(p)
    i, p = torch.broadcast_tensors(_u32(i, p.device), p)
    mult = 1 | (p >> 27)

    def rnd(i):
        i = i ^ p
        i = _mul32(i, 0xE170893D)
        i = i ^ (p >> 16)
        i = i ^ ((i & w) >> 4)
        i = i ^ (p >> 8)
        i = _mul32(i, 0x0929EB3F)
        i = i ^ (p >> 23)
        i = i ^ ((i & w) >> 1)
        i = (i * mult) & MASK32
        i = _mul32(i, 0x6935FA69)
        i = i ^ ((i & w) >> 11)
        i = _mul32(i, 0x74DCB303)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0x9E501CC3)
        i = i ^ ((i & w) >> 2)
        i = _mul32(i, 0xC860A3DF)
        i = i & w
        return i ^ (i >> 5)

    i = rnd(i)
    while bool((i >= l).any()):
        i = torch.where(i < l, i, rnd(i))
    return ((i + p) & MASK32) % l


@dataclass(frozen=True)
class Sampler:
    """kind "uniform" (nx = pixel samples, ny = 1) or "stratified" (an nx
    by ny jittered grid per 2D dimension, nx * ny strata per 1D one)."""

    kind: str
    nx: int
    ny: int = 1
    dtype: torch.dtype = torch.float32

    @property
    def spp(self) -> int:
        return self.nx * self.ny

    def _f(self, x: float, like):
        return torch.tensor(x, dtype=self.dtype, device=like.device)

    def get_1d(self, lanes: Lanes, dim: int):
        u = unit_float(lanes.dim_u32(dim), self.dtype)
        if self.kind == "uniform":
            return u
        stratum = permutation_element(lanes.sample_index, self.spp,
                                      hash_key(lanes.pixel_hash(), dim))
        x = stratum.to(self.dtype) + u
        return x / self._f(self.spp, x)

    def get_2d(self, lanes: Lanes, dim: int):
        u0 = unit_float(lanes.dim_u32(dim), self.dtype)
        u1 = unit_float(lanes.dim_u32(dim + 1), self.dtype)
        if self.kind == "uniform":
            return torch.stack([u0, u1], dim=-1)
        stratum = permutation_element(lanes.sample_index, self.spp,
                                      hash_key(lanes.pixel_hash(), dim))
        # The y index divides by the y count, as yuki's stratified.rs does.
        x = (stratum % self.nx).to(self.dtype) + u0
        y = (stratum // self.ny).to(self.dtype) + u1
        return torch.stack([x / self._f(self.nx, x), y / self._f(self.ny, y)],
                           dim=-1)


def concentric_sample_disk(u):
    offset = u * 2.0 - 1.0
    ox, oy = offset[..., 0], offset[..., 1]
    degenerate = (ox == 0.0) & (oy == 0.0)
    one = torch.ones_like(ox)
    ox_s = torch.where(ox == 0.0, one, ox)
    oy_s = torch.where(oy == 0.0, one, oy)
    use_x = torch.abs(ox) > torch.abs(oy)
    theta = torch.where(use_x, (math.pi / 4.0) * (oy / ox_s),
                        (math.pi / 2.0) - (math.pi / 4.0) * (ox / oy_s))
    r = torch.where(use_x, ox, oy)
    d = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1) * r[..., None]
    return torch.where(degenerate[..., None], torch.zeros_like(d), d)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = sqrt(torch.clamp(1.0 - d[..., 0] * d[..., 0] - d[..., 1] * d[..., 1],
                         min=0.0))
    return torch.stack([d[..., 0], d[..., 1], z], dim=-1)
