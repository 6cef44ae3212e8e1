"""The dense-scene path-tracing wave: port of ``yuki_tpu/ops/path_fused.py``.

A wave is one sample of every pixel in a set of film tiles.  Its state
crosses bounces as ``[24, N]`` float32 planes laid out as ``_ST`` (the
same planes as ``yuki_tpu``'s ``[24, rows, 128]`` carry, flattened), plus
an ``[N]`` int32 plane ``ph`` holding each lane's sampler hash.  Two
kernels carry the whole wave, or, with ``PATH_FUSED_ONEKERNEL``, one:

  raygen_trace  sampler pixel hash + jitter, camera ray, closest hit
                over every triangle and sphere   (replaces
                ``_raygen_trace_kernel``, path_fused.py:517)
  bounce        one bounce: miss/background, table rows, texel, the
                shading body, per-light NEE occlusion, resolve, and the
                next ray's closest hit   (replaces ``_bounce_kernel``,
                path_fused.py:709)
  wave          raygen and every bounce in one launch, the path state of
                each 1024-lane tile in shared memory, writing only radiance
                and the ray count (replaces ``_wave_kernel``,
                path_fused.py:788)

The uniform sampler's values are hashed inside the kernels.  A
``StratifiedSampler``'s are computed first as ``[2 + max_depth * (2L+3),
N]`` planes (``strat_planes``, yuki_tpu path_fused.py:1023-1051: strata
depend only on the pixel, sample and dimension, never on the path), and
each kernel reads its planes in place of the hash.  On the card the
planes are one launch of ``strat_draws_kernel`` (``ops/strat_draws``,
``csrc/sampling.cu``) a wave call, with no host read; on the CPU they are
the sampler's torch draws, the kernel's plain twin.

Each wrapper dispatches on where its tensors lie: a CUDA tensor launches
the hand-written kernel in ``csrc/path_fused.cu`` (or raises); a CPU
tensor runs the plain PyTorch version beside it (``raygen_trace_plain``,
``bounce_plain``), which the CPU tests hold against ``yuki_tpu``.  Each
kernel launch adds one to ``LAUNCHES``.  The kernels stage the scene's
sweep tables in shared memory; the raygen kernel stages them for its
camera rays, which share an origin: the triangles already translated by
it and permuted for each shear frame its rays need, and each sphere's
object-space origin and ``c``, with the same operations as
``raygen_trace_plain``'s sweep, so the same bits.  The bounce kernel
runs each 512-lane tile's lanes grouped by material class (dead, missed,
the hit's material type and surface); a lane still reads and writes its
own index, so no output depends on that order (``bounce_plain`` is
lane-permutation equivariant bit for bit).  The wave kernel does the same
on 1024-lane tiles at every bounce with the tile's live lanes alone, after raygen's camera
sweep, so it gives the two-kernel wave's bits.

The TPU-only tricks are gone: the MXU one-hot row selects
(``_select_row_mxu``) are row loads at ``max(idx, 0)``, and the MXU texel
and palette selects are ``texels_u8[idx]``.  ``_tex_index`` keeps its
float->int maths, with NaN and out-of-range values sanitised before the
conversion (C++ and torch leave those undefined).

Semantics kept from ``yuki_tpu``: the double-beta NEE emit quirk
(path_fused.py:660-664), ray counts that count closest hits only
(:700-705), spheres tested after the triangles with strict ties going to
the triangle (:185-207), and the lowest triangle index winning exact-t
ties (:108-141).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..integrators import PathParams
from ..profiling import pass_scope
from ..sampling import (GOLDEN, MASK32, SampleCtx, StratifiedSampler,
                        UniformSampler)
from ..scene.data import LIGHT_RECT
from ..vecmath import sqrt as _sqrt
from . import _build
from .shade_fused import (_where3, dim_f32, light_table, pcg, scene_center_diag,
                          shade_body, sphere_table)
from .strat_draws import strat_draws
from .trace import F32_MAX, pack_triangles, watertight

MAX_TRIS_WAVE = 1024  # dense-scene gate (yuki_tpu path_fused.py:75)
TEXPOOL_MAX = 65536  # texel-pool gate (path_fused.py:76)

# "auto": scenes that pass wave_supported render through the wave; "off":
# none do, and the renderer takes camera rays + path_li over the dense
# queries instead (yuki_tpu path_fused.py:864-866, :907-916).
PATH_FUSED_MODE = "auto"

# True: the wave runs as one launch of the wave kernel instead of raygen
# plus one bounce launch per depth (yuki_tpu path_fused.py:868-872, whose
# default this keeps).  The two forms give the same bits.
PATH_FUSED_ONEKERNEL = False

# State plane indices (f32 [24, N]).
_ST = dict(
    ox=0, oy=1, oz=2, dx=3, dy=4, dz=5,
    bx=6, by=7, bz=8, rx=9, ry=10, rz=11,
    alive=12, spec=13, rc=14,
    t=15, b0=16, b1=17, prim=18, sph=19, hitf=20,
    pad0=21, pad1=22, pad2=23,
)
_N_ST = 24

# Misc scalar-table slots ([128] f32): raster_to_camera 0-15,
# camera_to_world 16-31, scene centre 32-34, diag 35, background 36-38,
# indirect clamp 39.
_MS_R2C = 0
_MS_C2W = 16
_MS_CENTER = 32
_MS_DIAG = 35
_MS_BG = 36
_MS_CLAMP = 39
_MS_LEN = 128

# Runtime flag bits of the bounce kernel (the JAX kernel's statics).
FLAG_SIGMA = 1
FLAG_CLAMP = 2
FLAG_TEX = 4

# Kernel launches since the last reset_launches(); only the kernel
# branch of each wrapper counts.
LAUNCHES = {"raygen_trace": 0, "bounce": 0, "wave": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------
# Gate and tables
# --------------------------------------------------------------------


def wave_supported(meta, sampler) -> bool:
    """Static gate, decided from SceneMeta and the sampler only
    (yuki_tpu path_fused.py:880-904).  A dense scene it refuses renders
    through ``integrators.path_li`` where that accepts it."""
    if not isinstance(sampler, (UniformSampler, StratifiedSampler)):
        return False
    if meta.traversal != "dense" or meta.n_tris > MAX_TRIS_WAVE:
        return False
    if meta.n_tris == 0:
        return False
    if meta.n_spheres and not meta.sphere_mats_untextured:
        return False
    if len(meta.light_types) == 0:
        return False
    if meta.has_sigma_tex:
        return False
    if meta.has_textures and not (
        meta.texpool_u8_exact
        and meta.texpool_texels <= TEXPOOL_MAX
        and meta.n_textures <= 8
    ):
        return False
    return True


@dataclass
class WaveTables:
    """Everything a wave reads besides its pixels: the scene and camera
    tables on one device plus the statics the JAX kernels specialise on.
    Built once per (scene, camera, params) by ``make_tables``."""

    ms: torch.Tensor  # [128] f32 misc slots (_MS_*)
    tri: torch.Tensor  # [T, 12] f32 packed corners
    trs: torch.Tensor  # [T, 32] f32 shading rows
    mat: torch.Tensor  # [M, 16] f32 material rows
    lt: torch.Tensor  # [L, 32] f32 light rows
    sp: torch.Tensor  # [max(S,1), 40] f32 sphere rows
    td: torch.Tensor  # [K, 4] f32 texture descriptors (w, h, off_hi, off_lo)
    tex: torch.Tensor  # [pool_pad, 3] u8 texel pool, zero-padded
    n_tris: int
    n_spheres: int
    light_types: tuple
    present: frozenset
    has_sigma: bool
    has_clamp: bool
    has_tex: bool
    pool_pad: int
    max_depth: int

    @property
    def n_lights(self) -> int:
        return len(self.light_types)

    @property
    def dims_per_bounce(self) -> int:
        return 2 * self.n_lights + 3

    @property
    def device(self) -> torch.device:
        return self.ms.device

    @property
    def flags(self) -> int:
        return ((FLAG_SIGMA if self.has_sigma else 0)
                | (FLAG_CLAMP if self.has_clamp else 0)
                | (FLAG_TEX if self.has_tex else 0))


def _tex_tables(atlas, pool_texels: int):
    """Descriptor table [K,4] (w, h, off>>12, off&0xFFF as floats, as in
    yuki_tpu) + the u8 pool zero-padded to a multiple of 256 texels."""
    pool_pad = max(-(-pool_texels // 256), 1) * 256
    u8 = atlas.texels_u8
    tex = torch.zeros((pool_pad, 3), dtype=torch.uint8, device=u8.device)
    tex[: u8.shape[0]] = u8
    td = torch.stack(
        [
            atlas.width.to(torch.float32),
            atlas.height.to(torch.float32),
            (atlas.offset >> 12).to(torch.float32),
            (atlas.offset & 0xFFF).to(torch.float32),
        ],
        dim=1,
    ).contiguous()
    return td, tex, pool_pad


def make_tables(scene, camera, params: PathParams) -> WaveTables:
    """Build the wave's tables on the scene's device."""
    data, meta = scene.data, scene.meta
    dev = data.tris.p0.device
    f32 = dict(dtype=torch.float32, device=dev)

    center, diag = scene_center_diag(data)
    ms = torch.zeros(_MS_LEN, **f32)
    ms[_MS_R2C:_MS_R2C + 16] = torch.as_tensor(
        camera.raster_to_camera, **f32).reshape(16)
    ms[_MS_C2W:_MS_C2W + 16] = torch.as_tensor(
        camera.camera_to_world, **f32).reshape(16)
    ms[_MS_CENTER:_MS_CENTER + 3] = center
    ms[_MS_DIAG] = diag
    ms[_MS_BG:_MS_BG + 3] = data.background.to(torch.float32)
    if params.indirect_clamp is not None:
        ms[_MS_CLAMP] = float(params.indirect_clamp)

    has_tex = bool(meta.has_textures)
    if has_tex:
        td, tex, pool_pad = _tex_tables(data.textures, meta.texpool_texels)
    else:
        td = torch.zeros((1, 4), **f32)
        tex = torch.zeros((8 * 256, 3), dtype=torch.uint8, device=dev)
        pool_pad = 8 * 256

    return WaveTables(
        ms=ms,
        tri=pack_triangles(data.tris.p0, data.tris.p1, data.tris.p2),
        trs=data.tris.shading_packed.contiguous(),
        mat=data.materials.packed.contiguous(),
        lt=light_table(data.lights),
        sp=sphere_table(data.spheres, meta.n_spheres, dev),
        td=td,
        tex=tex,
        n_tris=meta.n_tris,
        n_spheres=meta.n_spheres,
        light_types=tuple(meta.light_types),
        present=frozenset(meta.material_types),
        has_sigma=bool(meta.has_sigma or meta.has_sigma_tex),
        has_clamp=params.indirect_clamp is not None,
        has_tex=has_tex,
        pool_pad=pool_pad,
        max_depth=params.max_depth,
    )


# --------------------------------------------------------------------
# Plain PyTorch versions of the two kernels
# --------------------------------------------------------------------


def _tri_closest(tb: WaveTables, o, d, t_max):
    """Watertight sweep in index order; a later triangle replaces the
    running hit only when strictly closer, so the lowest index wins exact
    ties (yuki_tpu path_fused.py:108-141)."""
    t = t_max
    prim = torch.full_like(t_max, -1, dtype=torch.int32)
    b0 = torch.zeros_like(t_max)
    b1 = torch.zeros_like(t_max)
    for i in range(tb.n_tris):
        cols = tb.tri[i, :9].unbind()
        hit, ti, bi0, bi1 = watertight(o[0], o[1], o[2], d[0], d[1], d[2],
                                       t, cols)
        closer = hit & (ti < t)
        t = torch.where(closer, ti, t)
        prim = torch.where(closer, i, prim)
        b0 = torch.where(closer, bi0, b0)
        b1 = torch.where(closer, bi1, b1)
    return t, prim, b0, b1


def _sphere_t(tb: WaveTables, s: int, o, d, t_max):
    """Object-space test of sphere ``s`` (stable-q quadratic,
    sphere.rs:37-89): (t, miss)."""
    m = tb.sp[s].unbind()
    ro = (
        m[0] * o[0] + m[1] * o[1] + m[2] * o[2] + m[3],
        m[4] * o[0] + m[5] * o[1] + m[6] * o[2] + m[7],
        m[8] * o[0] + m[9] * o[1] + m[10] * o[2] + m[11],
    )
    rd = (
        m[0] * d[0] + m[1] * d[1] + m[2] * d[2],
        m[4] * d[0] + m[5] * d[1] + m[6] * d[2],
        m[8] * d[0] + m[9] * d[1] + m[10] * d[2],
    )
    radius = m[32]
    a = rd[0] * rd[0] + rd[1] * rd[1] + rd[2] * rd[2]
    b = 2.0 * (rd[0] * ro[0] + rd[1] * ro[1] + rd[2] * ro[2])
    c = ro[0] * ro[0] + ro[1] * ro[1] + ro[2] * ro[2] - radius * radius
    discrim = b * b - 4.0 * a * c
    has_root = discrim >= 0.0
    rt = _sqrt(torch.clamp(discrim, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - rt), -0.5 * (b + rt))
    t0 = q / a
    t1 = c / torch.where(q == 0.0, 1e-30, q)
    lo_t = torch.minimum(t0, t1)
    hi_t = torch.maximum(t0, t1)
    miss = (lo_t > t_max) | (hi_t <= 0.0)
    t = torch.where(lo_t <= 0.0, hi_t, lo_t)
    return t, miss | (t > t_max) | ~has_root


def _spheres_closest(tb: WaveTables, o, d, t_max):
    """The closest sphere hit: (t, sphere id or -1)."""
    best_t = torch.full_like(t_max, F32_MAX)
    best_i = torch.full_like(t_max, -1, dtype=torch.int32)
    for s in range(tb.n_spheres):
        t, miss = _sphere_t(tb, s, o, d, t_max)
        closer = ~miss & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_i = torch.where(closer, s, best_i)
    return best_t, best_i


def _trace_scene(tb: WaveTables, o, d, t_max):
    """Closest hit: triangles, then spheres, a sphere winning only when
    strictly closer.  Returns f32 tensors (t, prim, b0, b1, sph, hitf)."""
    t, prim, b0, b1 = _tri_closest(tb, o, d, t_max)
    if tb.n_spheres:
        st_, si_ = _spheres_closest(tb, o, d, t_max)
        sphere_wins = (si_ >= 0) & (st_ < t)
        hit = (prim >= 0) | sphere_wins
        t = torch.where(sphere_wins, st_, t)
        prim = torch.where(sphere_wins, -1, prim)
        sph = torch.where(sphere_wins, si_, -1)
    else:
        hit = prim >= 0
        sph = torch.full_like(prim, -1)
    return (t, prim.to(torch.float32), b0, b1, sph.to(torch.float32),
            hit.to(torch.float32))


def _occluded(tb: WaveTables, skip_id: int, o, d, t_max, stats=None,
              worth=None):
    """Any hit over the triangles (skipping the sampled area light's own
    triangles, bvh.rs:287-293) or any sphere.  ``stats`` receives the
    tests the kernel's sweep makes for the ``worth`` lanes: each triangle
    ("tests") and then each sphere ("sphere_tests") until the first hit."""
    occ = torch.zeros_like(t_max, dtype=torch.bool)
    for i in range(tb.n_tris):
        cols = tb.tri[i, :9].unbind()
        hit, _, _, _ = watertight(o[0], o[1], o[2], d[0], d[1], d[2],
                                  t_max, cols)
        if skip_id >= 0:
            hit = hit & (tb.trs[i, 27] != float(skip_id))
        if stats is not None:
            stats["tests"] += int((worth & ~occ).sum())
        occ = occ | hit
    for s in range(tb.n_spheres):
        if stats is not None:
            stats["sphere_tests"] += int((worth & ~occ).sum())
        occ = occ | ~_sphere_t(tb, s, o, d, t_max)[1]
    return occ


def _u32_scalar(x: int, device) -> torch.Tensor:
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _ph_u32(ph: torch.Tensor) -> torch.Tensor:
    return ph.to(torch.int64) & MASK32


def _ph_i32(u: torch.Tensor) -> torch.Tensor:
    """u32 held in int64 -> the same bits as int32."""
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)


def strat_planes(sampler, px, py, sample_index: int, seed: int,
                 n_lights: int, max_depth: int):
    """A StratifiedSampler's values for a whole wave: [2 + max_depth *
    (2L+3), N] f32 planes in yuki_tpu's order (path_fused.py:1036-1049):
    the pixel jitter (dims 0-1), then per bounce 2 per light, 2 for the
    BSDF sample and 1 for roulette; one launch of the draws kernel on the
    card (``strat_draws``).  None for the uniform sampler, whose values
    the kernels hash themselves."""
    if not isinstance(sampler, StratifiedSampler):
        return None
    ctx = SampleCtx(px=px, py=py, sample_index=sample_index, seed=seed)
    draws = [(0, 2)]
    for b in range(max_depth):
        draws += _bounce_draw_list(2 + b * (2 * n_lights + 3), n_lights)
    return strat_draws(sampler, ctx, draws)


def _bounce_draw_list(dim0: int, n_lights: int) -> list:
    """One bounce's draws from dimension ``dim0``: a 2-D draw per light,
    one for the BSDF sample, a 1-D one for roulette."""
    return ([(dim0 + 2 * li, 2) for li in range(n_lights)]
            + [(dim0 + 2 * n_lights, 2), (dim0 + 2 * n_lights + 2, 1)])


def bounce_draws(sampler, ctx, dim0: int, n_lights: int) -> torch.Tensor:
    """One bounce's 2L+3 stratified values from dimension ``dim0``
    (yuki_tpu shade_fused.py:1157-1170): [2L+3, N] f32 planes, one launch
    of the draws kernel on the card."""
    return strat_draws(sampler, ctx, _bounce_draw_list(dim0, n_lights))


def _bounce_planes(spl, tb: WaveTables, bounce: int):
    """Bounce ``bounce``'s 2L+3 planes of ``strat_planes``, or None."""
    if spl is None:
        return None
    d0 = 2 + bounce * tb.dims_per_bounce
    return spl[d0:d0 + tb.dims_per_bounce]


def raygen_trace_plain(px, py, sample_index: int, seed: int,
                       tb: WaveTables, spl=None):
    """Plain version of the raygen kernel (yuki_tpu ``_raygen_values``):
    px/py [N] int32 -> (st [24, N] f32, ph [N] int32).  ``spl``: the
    stratified jitter planes [>= 2, N] in place of the hash, or None."""
    dev = px.device
    h = pcg(_u32_scalar(GOLDEN ^ (int(seed) & MASK32), dev))
    key = ((px.to(torch.int64) << 16) & MASK32) | (py.to(torch.int64) & MASK32)
    ph = pcg(pcg(h ^ key) ^ _u32_scalar(sample_index, dev))

    if spl is None:
        jx = dim_f32(ph, 0)
        jy = dim_f32(ph, 1)
    else:
        jx, jy = spl[0], spl[1]
    x = px.to(torch.float32) + jx
    y = py.to(torch.float32) + jy

    ms = tb.ms.unbind()

    def r2c(i, j):
        return ms[_MS_R2C + 4 * i + j]

    def c2w(i, j):
        return ms[_MS_C2W + 4 * i + j]

    # apply_p(r2c, (x, y, 0)) with projective divide.
    pcx = r2c(0, 0) * x + r2c(0, 1) * y + r2c(0, 3)
    pcy = r2c(1, 0) * x + r2c(1, 1) * y + r2c(1, 3)
    pcz = r2c(2, 0) * x + r2c(2, 1) * y + r2c(2, 3)
    w = r2c(3, 0) * x + r2c(3, 1) * y + r2c(3, 3)
    pcx, pcy, pcz = pcx / w, pcy / w, pcz / w
    # normalize: v / |v|, true divide
    l1 = _sqrt(pcx * pcx + pcy * pcy + pcz * pcz)
    pcx, pcy, pcz = pcx / l1, pcy / l1, pcz / l1
    dx = c2w(0, 0) * pcx + c2w(0, 1) * pcy + c2w(0, 2) * pcz
    dy = c2w(1, 0) * pcx + c2w(1, 1) * pcy + c2w(1, 2) * pcz
    dz = c2w(2, 0) * pcx + c2w(2, 1) * pcy + c2w(2, 2) * pcz
    l2 = _sqrt(dx * dx + dy * dy + dz * dz)
    d = (dx / l2, dy / l2, dz / l2)
    zero = torch.zeros_like(x)
    o = (c2w(0, 3) + zero, c2w(1, 3) + zero, c2w(2, 3) + zero)

    t_max = torch.full_like(x, F32_MAX)
    t, prim, b0, b1, sph, hitf = _trace_scene(tb, o, d, t_max)

    one = torch.ones_like(x)
    stv = dict(
        ox=o[0], oy=o[1], oz=o[2], dx=d[0], dy=d[1], dz=d[2],
        bx=one, by=one, bz=one, rx=zero, ry=zero, rz=zero,
        alive=one, spec=zero, rc=one,
        t=t, b0=b0, b1=b1, prim=prim, sph=sph, hitf=hitf,
        pad0=zero, pad1=zero, pad2=zero,
    )
    st = torch.stack([stv[name] for name in _ST], dim=0)
    return st, _ph_i32(ph)


def _trunc_i32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 toward zero, with NaN -> 0 and the range clamped
    first (the bare conversion is undefined there, path_fused.py:440-443);
    in-range values convert exactly as ``astype(int32)``."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -1e9, 1e9).to(torch.int32)


def _tex_index(tb: WaveTables, tex0_f, uv_s, uv_t):
    """eval_texture's index maths (textures.py:43-51: repeat wrap,
    y-flip, -0.5 texel centre, truncate toward zero, clamp).  Texture ids
    outside [0, K) read descriptor row 0, like the JAX one-hot select."""
    k = tb.td.shape[0]
    row = torch.where((tex0_f >= 0.0) & (tex0_f < k), tex0_f, 0.0)
    w_f, h_f, off_hi, off_lo = tb.td[row.to(torch.int64)].unbind(-1)
    s = uv_s - torch.floor(uv_s)
    t = uv_t - torch.floor(uv_t)
    t = 1.0 - t
    x = s * w_f - 0.5
    y = t * h_f - 0.5
    w_i = w_f.to(torch.int32)
    h_i = h_f.to(torch.int32)
    zero_i = torch.zeros_like(w_i)
    xi = torch.minimum(torch.maximum(_trunc_i32(x), zero_i), w_i - 1)
    yi = torch.minimum(torch.maximum(_trunc_i32(y), zero_i), h_i - 1)
    off = off_hi.to(torch.int32) * 4096 + off_lo.to(torch.int32)
    idx = off + yi * w_i + xi
    return torch.clamp(idx, 0, tb.pool_pad - 1)


def bounce_plain(st: torch.Tensor, ph: torch.Tensor, bounce: int,
                 tb: WaveTables, spl=None, stats=None) -> torch.Tensor:
    """Plain version of the bounce kernel (yuki_tpu ``_bounce_values`` +
    ``_bounce_kernel``'s writes and next-ray trace): state in, state out.
    ``spl``: this bounce's [2L+3, N] stratified planes, or None.
    ``stats`` (a dict) receives the sweeps' work as the kernel does it:
    "tests" (triangle tests) and "sphere_tests", for the next hit's full
    sweep of every lane that traces one and each light's shadow sweep of
    every lane worth a shadow ray, up to its first hit."""
    dim0 = 2 + bounce * tb.dims_per_bounce

    def s(name):
        return st[_ST[name]]

    o = (s("ox"), s("oy"), s("oz"))
    d = (s("dx"), s("dy"), s("dz"))
    beta = (s("bx"), s("by"), s("bz"))
    rad = (s("rx"), s("ry"), s("rz"))
    alive_in = s("alive") > 0.0
    spec = s("spec")
    rc = s("rc")
    b0 = s("b0")
    b1 = s("b1")
    prim = s("prim")
    sph = s("sph")
    hitf = s("hitf") > 0.0
    zero = torch.zeros_like(rc)

    missed = alive_in & ~hitf
    alive_h = alive_in & hitf

    # Triangle shading row + material row (negative ids read row 0).
    trp = tb.trs[torch.clamp(prim, min=0.0).to(torch.int64)]
    mid = trp[:, 26]
    for si in range(tb.n_spheres):
        mid = torch.where(sph == float(si), tb.sp[si, 34], mid)
    mrow = tb.mat[torch.clamp(mid, min=0.0).to(torch.int64)]
    kd = (mrow[:, 1], mrow[:, 2], mrow[:, 3])
    if tb.has_tex:
        b2 = 1.0 - b0 - b1
        uv_s = trp[:, 18] * b0 + trp[:, 20] * b1 + trp[:, 22] * b2
        uv_t = trp[:, 19] * b0 + trp[:, 21] * b1 + trp[:, 23] * b2
        tex0 = mrow[:, 9]
        idx = _tex_index(tb, tex0, uv_s, uv_t)
        texel = tb.tex[idx.to(torch.int64)].to(torch.float32)
        texel = texel / torch.full_like(texel, 255.0)
        kd = _where3(tex0 >= 0.0, texel.unbind(-1), kd)

    rhd = dict(
        ox=o[0], oy=o[1], oz=o[2], dx=d[0], dy=d[1], dz=d[2],
        t=s("t"), b0=b0, b1=b1, sph=sph,
        alive=alive_h.to(torch.float32),
        bx=beta[0], by=beta[1], bz=beta[2], spec=spec,
    )
    mpd = dict(
        mtype=mrow[:, 0], kdx=kd[0], kdy=kd[1], kdz=kd[2],
        c1x=mrow[:, 4], c1y=mrow[:, 5], c1z=mrow[:, 6], s0=mrow[:, 7],
        remap=mrow[:, 8],
    )
    ms = tb.ms.unbind()
    center = (ms[_MS_CENTER], ms[_MS_CENTER + 1], ms[_MS_CENTER + 2])
    o2, d2v, beta2, alive2, spec2, ne, nee = shade_body(
        dim0, bounce,
        rh=lambda name: rhd[name],
        tr=lambda i: trp[:, i],
        mp=lambda name: mpd[name],
        ltab=lambda li, i: tb.lt[li, i],
        spm=lambda si, i: tb.sp[si, i],
        center=center,
        diag=ms[_MS_DIAG],
        ph_base=_ph_u32(ph),
        n_lights=tb.n_lights, light_types=tb.light_types,
        n_spheres=tb.n_spheres, present=tb.present, has_sigma=tb.has_sigma,
        urand=None if spl is None else spl.__getitem__,
    )

    # NEE occlusion per light.
    if stats is not None:
        stats.setdefault("tests", 0)
        stats.setdefault("sphere_tests", 0)
    occs = []
    for li, (o_s, d_s, t_s, worth, contrib) in enumerate(nee):
        skip = li if tb.light_types[li] == LIGHT_RECT else -2
        occs.append(_occluded(tb, skip, o_s, d_s, t_s, stats, worth))

    # Resolve: background first, the per-light fold seeded with the
    # beta*emitted term (the outer beta below is the reference's
    # double-beta emit quirk, path.rs:126-137), clamp past bounce 0, then
    # the radiance update on live lanes.
    bg = (ms[_MS_BG], ms[_MS_BG + 1], ms[_MS_BG + 2])
    rad = _where3(
        missed,
        (rad[0] + beta[0] * bg[0], rad[1] + beta[1] * bg[1],
         rad[2] + beta[2] * bg[2]),
        rad,
    )
    br = ne
    for li, (o_s, d_s, t_s, worth, contrib) in enumerate(nee):
        lit = worth & ~occs[li]
        br = (
            br[0] + torch.where(lit, contrib[0], zero),
            br[1] + torch.where(lit, contrib[1], zero),
            br[2] + torch.where(lit, contrib[2], zero),
        )
    if tb.has_clamp and bounce > 0:
        clamp_v = ms[_MS_CLAMP]
        br = (torch.minimum(br[0], clamp_v), torch.minimum(br[1], clamp_v),
              torch.minimum(br[2], clamp_v))
    rad = _where3(
        alive_h,
        (rad[0] + beta[0] * br[0], rad[1] + beta[1] * br[1],
         rad[2] + beta[2] * br[2]),
        rad,
    )

    # Ray counts: bounce b owns the count of bounce b+1's closest hit, so
    # the last bounce adds nothing.
    not_last = bounce < tb.max_depth - 1
    rc2 = rc + alive2.to(torch.float32) * (1.0 if not_last else 0.0)

    if not_last:
        t_max2 = torch.where(alive2, F32_MAX, 0.0)
        if stats is not None:
            traced = int(alive2.sum())
            stats["tests"] += traced * tb.n_tris
            stats["sphere_tests"] += traced * tb.n_spheres
        t, prim2, nb0, nb1, sph2, hitf2 = _trace_scene(tb, o2, d2v, t_max2)
    else:
        t, nb0, nb1, hitf2 = zero, zero, zero, zero
        prim2 = sph2 = zero - 1.0
    out = dict(
        ox=o2[0], oy=o2[1], oz=o2[2], dx=d2v[0], dy=d2v[1], dz=d2v[2],
        bx=beta2[0], by=beta2[1], bz=beta2[2],
        rx=rad[0], ry=rad[1], rz=rad[2],
        alive=alive2.to(torch.float32), spec=spec2.to(torch.float32), rc=rc2,
        t=t, b0=nb0, b1=nb1, prim=prim2, sph=sph2, hitf=hitf2,
        pad0=zero, pad1=zero, pad2=zero,
    )
    return torch.stack([out[name] for name in _ST], dim=0)


# --------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------


def _check_tables(tb: WaveTables, device) -> None:
    f32 = torch.float32
    _build.check(tb.ms, "ms", f32, (_MS_LEN,), device)
    _build.check(tb.tri, "tri", f32, (tb.tri.shape[0], 12), device)
    _build.check(tb.trs, "trs", f32, (tb.tri.shape[0], 32), device)
    _build.check(tb.mat, "mat", f32, (tb.mat.shape[0], 16), device)
    _build.check(tb.lt, "lt", f32, (tb.n_lights, 32), device)
    _build.check(tb.sp, "sp", f32, (max(tb.n_spheres, 1), 40), device)
    _build.check(tb.td, "td", f32, (tb.td.shape[0], 4), device)
    _build.check(tb.tex, "tex", torch.uint8, (tb.pool_pad, 3), device)
    if tb.n_tris > tb.tri.shape[0]:
        raise ValueError("n_tris exceeds the triangle table")


def _check_spl(spl, planes: int, n: int, dev):
    """The stratified planes' pointer for a kernel (None: the hash)."""
    if spl is None:
        return None
    _build.check(spl, "spl", torch.float32, (planes, n), dev)
    return _build.ptr(spl)


def raygen_trace(px: torch.Tensor, py: torch.Tensor, sample_index: int,
                 seed: int, tb: WaveTables, spl=None):
    """Camera rays of one sample + their closest hits: px/py [N] int32 ->
    (st [24, N] f32, ph [N] int32).  ``spl``: the stratified jitter planes
    [2, N], or None for the uniform sampler's hash.  CUDA tensors launch
    the raygen kernel; CPU tensors run ``raygen_trace_plain``."""
    if not _build.dispatch(px):
        return raygen_trace_plain(px, py, sample_index, seed, tb, spl)
    dev = px.device
    n = px.shape[0]
    _build.check(px, "px", torch.int32, (n,), dev)
    _build.check(py, "py", torch.int32, (n,), dev)
    _check_tables(tb, dev)
    _build.check_aligned(tb.tri, "tri")
    spl_p = _check_spl(spl, 2, n, dev)
    st = torch.empty((_N_ST, n), dtype=torch.float32, device=dev)
    ph = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return st, ph
    lib = _build.library()
    err = lib.yk_raygen_trace(
        dev.index, _build.ptr(px), _build.ptr(py), n,
        ctypes.c_uint32(int(sample_index) & MASK32),
        ctypes.c_uint32(int(seed) & MASK32),
        _build.ptr(tb.ms), _build.ptr(tb.tri), tb.n_tris, _build.ptr(tb.trs),
        _build.ptr(tb.sp), tb.n_spheres, spl_p, _build.ptr(st), _build.ptr(ph),
        _build.stream(dev),
    )
    _build.launch_check(err, "raygen_trace")
    _build.bump(LAUNCHES, "raygen_trace")
    return st, ph


def bounce(st: torch.Tensor, ph: torch.Tensor, bounce_index: int,
           tb: WaveTables, spl=None) -> torch.Tensor:
    """One path bounce: state [24, N] -> state [24, N].  ``spl``: this
    bounce's [2L+3, N] stratified planes, or None for the uniform
    sampler's hash.  CUDA tensors launch the bounce kernel; CPU tensors
    run ``bounce_plain``."""
    if not _build.dispatch(st):
        return bounce_plain(st, ph, bounce_index, tb, spl)
    dev = st.device
    n = st.shape[1]
    _build.check(st, "st", torch.float32, (_N_ST, n), dev)
    _build.check(ph, "ph", torch.int32, (n,), dev)
    _check_tables(tb, dev)
    spl_p = _check_spl(spl, tb.dims_per_bounce, n, dev)
    if not 0 <= bounce_index < tb.max_depth:
        raise ValueError(f"bounce {bounce_index} outside [0, {tb.max_depth})")
    out = torch.empty_like(st)
    if n == 0:
        return out
    lib = _build.library()
    dim0 = 2 + bounce_index * tb.dims_per_bounce
    err = lib.yk_bounce(
        dev.index, _build.ptr(st), _build.ptr(ph), _build.ptr(out), n, dim0, bounce_index, tb.max_depth,
        _build.ptr(tb.ms), _build.ptr(tb.tri), tb.n_tris, _build.ptr(tb.trs), _build.ptr(tb.mat),
        _build.ptr(tb.lt), tb.n_lights, _build.ptr(tb.sp), tb.n_spheres,
        _build.ptr(tb.td), tb.td.shape[0], _build.ptr(tb.tex), tb.pool_pad, tb.flags,
        spl_p, _build.stream(dev),
    )
    _build.launch_check(err, "bounce")
    _build.bump(LAUNCHES, "bounce")
    return out


def wave_plain(px, py, sample_index: int, seed: int, tb: WaveTables,
               spl=None) -> torch.Tensor:
    """Plain version of the wave kernel: raygen, then every bounce, on
    the plain versions of the two kernels.  Returns [4, N] f32: radiance
    rgb and the ray count."""
    st, ph = raygen_trace_plain(px, py, sample_index, seed, tb, spl)
    for b in range(tb.max_depth):
        st = bounce_plain(st, ph, b, tb, _bounce_planes(spl, tb, b))
    return st[[_ST["rx"], _ST["ry"], _ST["rz"], _ST["rc"]]]


def wave(px: torch.Tensor, py: torch.Tensor, sample_index: int, seed: int,
         tb: WaveTables, spl=None) -> torch.Tensor:
    """One sample of a wave in one launch: px/py [N] int32 -> [4, N] f32
    (radiance rgb, ray count).  ``spl``: ``strat_planes`` or None.  CUDA
    tensors launch the wave kernel; CPU tensors run ``wave_plain``."""
    if not _build.dispatch(px):
        return wave_plain(px, py, sample_index, seed, tb, spl)
    dev = px.device
    n = px.shape[0]
    _build.check(px, "px", torch.int32, (n,), dev)
    _build.check(py, "py", torch.int32, (n,), dev)
    _check_tables(tb, dev)
    spl_p = _check_spl(spl, 2 + tb.max_depth * tb.dims_per_bounce, n, dev)
    out = torch.empty((4, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _build.library().yk_wave(
        dev.index, _build.ptr(px), _build.ptr(py), n,
        ctypes.c_uint32(int(sample_index) & MASK32),
        ctypes.c_uint32(int(seed) & MASK32), tb.max_depth,
        _build.ptr(tb.ms), _build.ptr(tb.tri), tb.n_tris, _build.ptr(tb.trs), _build.ptr(tb.mat),
        _build.ptr(tb.lt), tb.n_lights, _build.ptr(tb.sp), tb.n_spheres,
        _build.ptr(tb.td), tb.td.shape[0], _build.ptr(tb.tex), tb.pool_pad, tb.flags,
        spl_p, _build.ptr(out), _build.stream(dev),
    )
    _build.launch_check(err, "wave")
    _build.bump(LAUNCHES, "wave")
    return out


# --------------------------------------------------------------------
# The wave: one raygen launch and one bounce launch per depth, or one
# wave launch
# --------------------------------------------------------------------


def path_li_wave(tb: WaveTables, px: torch.Tensor, py: torch.Tensor,
                 sample_index: int, seed: int, sampler=None):
    """One sample of a wave of pixels: px/py [N] int32 -> (li [N,3] f32,
    ray_count [N] int32).  Consumes sampler dims like yuki_tpu's wave:
    0-1 for the jitter, then 2 + b*(2L+3) per bounce.  ``sampler`` None
    is the uniform sampler; a StratifiedSampler's values are computed
    first (``strat_planes``)."""
    spl = strat_planes(sampler, px, py, sample_index, seed, tb.n_lights,
                       tb.max_depth)
    if PATH_FUSED_ONEKERNEL:
        with pass_scope("path_fused.wave1k"):
            out = wave(px, py, sample_index, seed, tb, spl)
        return out[:3].t(), out[3].to(torch.int32)
    with pass_scope("path_fused.raygen_trace"):
        st, ph = raygen_trace(px, py, sample_index, seed, tb,
                              None if spl is None else spl[:2])
    with pass_scope("path_fused.bounces"):
        for b in range(tb.max_depth):
            st = bounce(st, ph, b, tb, _bounce_planes(spl, tb, b))
    li = torch.stack([st[_ST["rx"]], st[_ST["ry"]], st[_ST["rz"]]], dim=-1)
    return li, st[_ST["rc"]].to(torch.int32)

