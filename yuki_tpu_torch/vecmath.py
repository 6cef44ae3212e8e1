"""Batched 3D maths over tensors: port of ``yuki_tpu/vecmath.py``.

Positions, directions, normals and RGB spectra are all float32 tensors
with a trailing component axis of 3, and every helper is elementwise over
the leading axes.

Two rules keep the results the bits of eager ``yuki_tpu`` on the CPU and
on the card:

``sqrt`` is the correctly rounded square root.  XLA and CUDA (without
fast-math) round ``sqrt`` exactly, but torch's CPU float32 ``sqrt`` goes
through a vector library that is off by an ulp on about 1% of inputs, and
the watertight edge functions and near-grazing hemisphere samples amplify
such an ulp.  The float64 square root of a float32, rounded back to
float32, is the correctly rounded float32 result (53 >= 2*24 + 2 bits, so
the double rounding is innocuous).  Every square root of the port goes
through it.

Every division has a tensor divisor (``const`` makes one): on CUDA torch
computes ``tensor / python_scalar`` (or a CPU scalar tensor) as a multiply
by the scalar's reciprocal, which rounds twice.  Dot products are summed
left to right as written, the order of XLA's reduce over three
components.
"""

from __future__ import annotations

import threading

import torch


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded elementwise square root, in x's dtype."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


_consts: dict = {}
_consts_lock = threading.Lock()


def const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor on ``like``'s device (cached, read only),
    to divide by.  The cache is filled under a lock: the viewer's request
    threads and the renderer's manager thread shade at once."""
    key = (float(value), like.device)
    c = _consts.get(key)
    if c is None:
        with _consts_lock:
            c = _consts.get(key)
            if c is None:
                c = torch.tensor(key[0], dtype=torch.float32,
                                 device=like.device)
                _consts[key] = c
    return c


def recip(x: torch.Tensor) -> torch.Tensor:
    """IEEE 1 / x."""
    return const(1.0, x) / x


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing component axis. Returns [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis of size 3."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length_sqr(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def length(a: torch.Tensor) -> torch.Tensor:
    return sqrt(length_sqr(a))


def normalize(a: torch.Tensor) -> torch.Tensor:
    """a / |a|, no epsilon guard (Vec3::normalized)."""
    return a / length(a)[..., None]


def normalize_safe(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """a / max(|a|, eps): for lanes that may hold garbage under masking."""
    return a / torch.clamp(length(a), min=eps)[..., None]


def dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length(a - b)


def dist_sqr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return length_sqr(a - b)


def face_forward(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Flip n into the hemisphere of v (Normal::faceforward_v,
    yuki/src/math/normal.rs:53-87)."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def reflect(wo: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror wo about n (materials/bsdfs/mod.rs:298-300)."""
    return -wo + n * (2.0 * dot(wo, n))[..., None]


def coordinate_system(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An orthonormal basis around the normalized v (pbrt-v3, yuki
    math/mod.rs:23-34, with the reference's ``v.z + v.z`` typo fixed to
    ``sqrt(v.y^2 + v.z^2)``, as yuki_tpu fixes it)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = recip(sqrt(torch.where(use_x, x * x + z * z, y * y + z * z)))
    zeros = torch.zeros_like(x)
    v1 = torch.where(
        use_x[..., None],
        torch.stack([-z, zeros, x], dim=-1),
        torch.stack([zeros, z, -y], dim=-1),
    ) * inv_a[..., None]
    return v1, cross(v, v1)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return a + (b - a) * t


def is_black(s: torch.Tensor) -> torch.Tensor:
    """Spectrum::is_black: every component == 0."""
    return torch.all(s == 0.0, dim=-1)


def max_dimension(v: torch.Tensor) -> torch.Tensor:
    """Index of the largest component (Vec3::max_dimension), [...] i32."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.where((x > y) & (x > z), 0,
                       torch.where(y > z, 1, 2)).to(torch.int32)


def permute(v: torch.Tensor, kx, ky, kz) -> torch.Tensor:
    """Gather components (Vec3::permuted) with per-lane index tensors."""
    take = lambda k: torch.gather(v, -1, k.to(torch.int64)[..., None])[..., 0]
    return torch.stack([take(kx), take(ky), take(kz)], dim=-1)
