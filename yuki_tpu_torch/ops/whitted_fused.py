"""Whitted's tree step in two CUDA kernels (``csrc/whitted_fused.cu``).

``integrators.whitted_li`` walks each lane's recursion tree one node a
step.  On CUDA lanes a step is:
the step's stratified draws (one ``strat_draws`` launch; the uniform
sampler's values are hashed in the kernel), the triangles' closest query
(``traverse.closest_triangles``: the dense sweep or the treelet dispatch),
``whitted_shade``, the triangles' occlusion query
(``traverse.any_triangles``) and ``whitted_resolve``.  Both kernels run
one thread a lane in wave order, reading the scene's shading, material,
light, sphere and texture tables with ``__ldg`` as the shade kernels do
(added, no TPU twin: yuki_tpu runs Whitted as XLA ops):

  whitted_shade    the spheres against the triangles' hit (``intersect``'s
                   merge), the lane's ray count, the surface
                   (``make_surface``), its material (``gather_materials``,
                   textures included), each light's shadow ray and raw
                   contribution f Li cos / pdf, light-major as
                   ``_nee_setup`` lays them out, the area-light emission
                   where ``cur_spec | depth == 0``, and the reflection and
                   transmission children of ``bsdf_sample_specular``
  whitted_resolve  the spheres' occlusion ORed into the triangles'
                   verdicts (``any_intersect``), the miss background, the
                   lit contributions summed in light order
                   (``_nee_resolve``) and the radiance, the transmission
                   child pushed and the stack popped where no reflection
                   child goes on (``_push``, ``_pop``), and the next ray,
                   parked at the scene centre where the lane is idle

Each kernel follows the chain's operations in its order (``-fmad=false``,
IEEE divides, correctly rounded square roots, dots summed left to right),
so it gives its plain twin's bits: ``whitted_shade_plain`` and
``whitted_resolve_plain`` are that twin, written with the chain's own
functions, and run on CPU lanes.  Each launch adds one to ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import _build
from .shade_fused import light_table, sphere_table
from .trace import F32_MAX
from ..sampling import MASK32, StratifiedSampler

# Lane flags the shade kernel writes for the resolve kernel.
LIVE, MISSED, REFL, TRANS = 1, 2, 4, 8

# Table flags: gather_materials' and bsdf_f's static facts of the scene.
FLAG_SIGMA, FLAG_TEX, FLAG_SIGMA_TEX = 1, 2, 4

LAUNCHES = {"whitted_shade": 0, "whitted_resolve": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class WhittedTables:
    """What both kernels read besides the lanes: the scene's tables on its
    device and the statics of ``whitted_li``'s call."""

    data: object  # SceneData (the twins call the chain with it)
    meta: object  # SceneMeta
    trs: torch.Tensor  # [T,32] f32 shading rows
    mat: torch.Tensor  # [M,16] f32 material rows
    lt: torch.Tensor  # [max(L,1),32] f32 light rows (shade_fused layout)
    sp: torch.Tensor  # [max(S,1),40] f32 sphere rows
    consts: torch.Tensor  # [8] f32: centre xyz, distant diag, background xyz
    skip: torch.Tensor  # [L*N] i32 each shadow ray's skip light
    n_lights: int
    n_spheres: int
    flags: int
    depth_cap: int
    size: int  # stack entries

    @property
    def center(self) -> torch.Tensor:
        return self.consts[0:3]


def make_whitted_tables(scene, params, n: int) -> WhittedTables:
    """The tables of one ``whitted_li`` call over ``n`` lanes, built on the
    scene's device with no host read.  The centre and the distant lights'
    parking distance are the chain's expressions (``integrators._center``,
    ``lights.sample_li``)."""
    from ..lights import NO_SKIP
    from ..scene.data import LIGHT_RECT
    from ..vecmath import dot, sqrt

    data, meta = scene.data, scene.meta
    dev = data.tris.p0.device
    ext = data.world_hi - data.world_lo
    diag = sqrt(dot(ext, ext)) * 1.002 + 1e-3
    consts = torch.cat([0.5 * (data.world_lo + data.world_hi), diag[None],
                        data.background.to(torch.float32),
                        torch.zeros(1, dtype=torch.float32, device=dev)])
    skip = torch.cat([
        torch.full((n,), li if lt == LIGHT_RECT else NO_SKIP,
                   dtype=torch.int32, device=dev)
        for li, lt in enumerate(meta.light_types)
    ]) if meta.light_types else torch.zeros(0, dtype=torch.int32, device=dev)
    flags = ((FLAG_SIGMA if meta.has_sigma else 0)
             | (FLAG_TEX if meta.has_textures else 0)
             | (FLAG_SIGMA_TEX if meta.has_sigma_tex else 0))
    return WhittedTables(
        data=data, meta=meta,
        trs=data.tris.shading_packed.contiguous(),
        mat=data.materials.packed.contiguous(),
        lt=light_table(data.lights),
        sp=sphere_table(data.spheres, meta.n_spheres, dev),
        consts=consts.contiguous(), skip=skip,
        n_lights=len(meta.light_types), n_spheres=meta.n_spheres,
        flags=flags, depth_cap=params.max_depth,
        size=max(params.max_depth, 1),
    )


@dataclass
class WhittedState:
    """A wave's tree walk: the current ray of each lane, its carry, the
    radiance and ray count so far, and the stack of pending transmission
    children ([size, N] entries, ``whitted_li``'s layout).  The resolve
    step rewrites it in place."""

    o: torch.Tensor  # [N,3]
    d: torch.Tensor  # [N,3]
    t_max: torch.Tensor  # [N] F32_MAX where active, else 0
    scale: torch.Tensor  # [N,3]
    depth: torch.Tensor  # [N] i32
    spec: torch.Tensor  # [N] bool
    active: torch.Tensor  # [N] bool
    radiance: torch.Tensor  # [N,3]
    ray_count: torch.Tensor  # [N] i32
    sp: torch.Tensor  # [N] i32 stack pointer
    stack: dict  # o, d, scale [size,N,3]; depth [size,N] i32; spec bool
    pending: torch.Tensor  # [N] bool: active or a stack entry left


def init_state(tb: WhittedTables, o, d) -> WhittedState:
    """Every lane active on its camera ray (copied: the walk rewrites
    its rays in place)."""
    n, dev = o.shape[0], o.device
    f32 = dict(dtype=torch.float32, device=dev)
    size = tb.size
    return WhittedState(
        o=o.to(torch.float32).clone().contiguous(),
        d=d.to(torch.float32).clone().contiguous(),
        t_max=torch.full((n,), F32_MAX, **f32),
        scale=torch.ones((n, 3), **f32),
        depth=torch.zeros(n, dtype=torch.int32, device=dev),
        spec=torch.zeros(n, dtype=torch.bool, device=dev),
        active=torch.ones(n, dtype=torch.bool, device=dev),
        radiance=torch.zeros((n, 3), **f32),
        ray_count=torch.zeros(n, dtype=torch.int32, device=dev),
        sp=torch.zeros(n, dtype=torch.int32, device=dev),
        stack={
            "o": torch.zeros((size, n, 3), **f32),
            "d": torch.zeros((size, n, 3), **f32),
            "scale": torch.zeros((size, n, 3), **f32),
            "depth": torch.zeros((size, n), dtype=torch.int32, device=dev),
            "spec": torch.zeros((size, n), dtype=torch.bool, device=dev),
        },
        pending=torch.ones(n, dtype=torch.bool, device=dev),
    )


class ShadeOut(NamedTuple):
    """The shade step's outputs.  Per light, light-major [L*N]: the
    shadow ray (o, d, t_max 0.9999 where worth a ray, else 0 and parked)
    and its contribution f Li cos / pdf (0 where not worth a ray).  Per
    lane: the emission term, the reflection and transmission children
    (o, d, scale as [N,9] rows) and the lane flags."""

    no: torch.Tensor  # [L*N,3]
    nd: torch.Tensor  # [L*N,3]
    nt: torch.Tensor  # [L*N]
    nc: torch.Tensor  # [L*N,3]
    emit: torch.Tensor  # [N,3]
    refl: torch.Tensor  # [N,9]
    trans: torch.Tensor  # [N,9]
    lane: torch.Tensor  # [N] u8: LIVE | MISSED | REFL | TRANS


def step_draws(sampler, ctx, dim0: int, n_lights: int):
    """The step's 2L NEE values from ``dim0`` as [2L, N] planes, one
    ``strat_draws`` launch on the card; None for the uniform sampler,
    whose values the kernel hashes from ``ph``."""
    if not isinstance(sampler, StratifiedSampler) or not n_lights:
        return None
    from .strat_draws import strat_draws

    return strat_draws(sampler, ctx,
                       [(dim0 + 2 * li, 2) for li in range(n_lights)])


def uniform_draws(ph, dim0: int, n_lights: int) -> torch.Tensor:
    """The uniform sampler's 2L values of a step from ``ph`` (pcg(pixel
    hash ^ sample index) as int32): [2L, N] planes, UniformSampler.get_2d's
    bits."""
    from .shade_fused import dim_f32

    base = ph.to(torch.int64) & MASK32
    return torch.stack([dim_f32(base, dim0 + k) for k in range(2 * n_lights)])


class _Planes:
    """A sampler over a step's draw planes, for the chain's _nee_setup:
    get_2d(ctx, dim) is the planes of dim and dim + 1."""

    def __init__(self, planes, dim0: int):
        self.planes, self.dim0 = planes, dim0

    def get_2d(self, ctx, dim: int) -> torch.Tensor:
        k = dim - self.dim0
        return self.planes[k:k + 2].t()


# --------------------------------------------------------------------
# Plain twins: the chain's functions on the kernels' inputs and outputs
# --------------------------------------------------------------------


def whitted_shade_plain(tb: WhittedTables, st: WhittedState, tri_hit,
                        dim0: int, draws=None, ph=None) -> ShadeOut:
    """Plain version of the shade kernel: ``tri_hit`` (t, prim, b0, b1)
    the triangles' closest hit of the current rays, ``draws`` the step's
    [2L, N] stratified planes or None, then ``ph`` [N] i32 gives the
    uniform sampler's.  Adds the active lanes to ``st.ray_count``."""
    from .. import bsdf as bsdf_mod
    from .. import lights as lights_mod
    from ..integrators import _nee_setup
    from ..intersect import ray_spheres
    from ..surface import make_surface, spawn_ray
    from ..traverse import SceneHit
    from ..vecmath import dot

    data, meta = tb.data, tb.meta
    L = tb.n_lights
    t, prim, b0, b1 = tri_hit
    st.ray_count = st.ray_count + st.active.to(torch.int32)
    sh = ray_spheres(st.o, st.d, st.t_max, data.spheres)
    sphere_wins = sh.hit & (sh.t < t)
    hit = SceneHit(hit=(prim >= 0) | sphere_wins,
                   t=torch.where(sphere_wins, sh.t, t),
                   prim=torch.where(sphere_wins, -1, prim),
                   sphere=torch.where(sphere_wins, sh.sphere, -1),
                   b0=b0, b1=b1)
    missed = st.active & ~hit.hit
    live = st.active & hit.hit
    si = make_surface(data, hit, st.o, st.d)
    mp = bsdf_mod.gather_materials(data, si, meta)
    if L:
        if draws is None:
            draws = uniform_draws(ph, dim0, L)
        no, nd, nt, _, worth, contrib, _ = _nee_setup(
            data, meta, _Planes(draws, dim0), None, si, mp, dim0, live)
        nc = torch.where(worth[..., None], contrib, 0.0)
    else:
        no = nd = nc = torch.zeros((0, 3), dtype=torch.float32,
                                   device=st.o.device)
        nt = torch.zeros(0, dtype=torch.float32, device=st.o.device)
    emit_mask = st.spec | (st.depth == 0)
    emit = torch.where(emit_mask[..., None],
                       lights_mod.area_light_radiance(data, si, -st.d), 0.0)
    can_recurse = live & (st.depth + 1 < tb.depth_cap)

    def child(bs):
        scale = bs.f * torch.abs(dot(bs.wi, si.ns))[..., None]
        scale = torch.where(torch.isfinite(scale), scale, 0.0) * st.scale
        return torch.cat([spawn_ray(si, bs.wi), bs.wi, scale], dim=1)

    bs_r = bsdf_mod.bsdf_sample_specular(mp, si, si.wo, False)
    bs_t = bsdf_mod.bsdf_sample_specular(mp, si, si.wo, True)
    lane = (live.to(torch.uint8) * LIVE + missed.to(torch.uint8) * MISSED
            + (can_recurse & bs_r.valid).to(torch.uint8) * REFL
            + (can_recurse & bs_t.valid).to(torch.uint8) * TRANS)
    return ShadeOut(no=no, nd=nd, nt=nt, nc=nc, emit=emit, refl=child(bs_r),
                    trans=child(bs_t), lane=lane)


def whitted_resolve_plain(tb: WhittedTables, st: WhittedState,
                          so: ShadeOut, occ) -> None:
    """Plain version of the resolve kernel: ``occ`` [L*N] bool the
    triangles' occlusion of the shadow rays.  Rewrites ``st``."""
    from ..integrators import _nee_resolve, _pop, _push
    from ..intersect import ray_spheres

    data = tb.data
    n, L = st.o.shape[0], tb.n_lights
    live = (so.lane & LIVE) > 0
    missed = (so.lane & MISSED) > 0
    r_valid = (so.lane & REFL) > 0
    t_valid = (so.lane & TRANS) > 0
    if L:
        occ = occ | ray_spheres(so.no, so.nd, so.nt, data.spheres).hit
        direct = _nee_resolve(occ, so.nt > 0.0, so.nc, n, L)
    else:
        direct = torch.zeros_like(st.radiance)
    direct = direct + so.emit
    radiance = st.radiance + torch.where(missed[..., None],
                                         st.scale * data.background, 0.0)
    st.radiance = radiance + torch.where(live[..., None], st.scale * direct,
                                         0.0)

    def item(rows):
        return {"o": rows[:, 0:3], "d": rows[:, 3:6], "scale": rows[:, 6:9],
                "depth": st.depth + 1, "spec": torch.ones_like(st.spec)}

    sp = _push(st.stack, st.sp, item(so.trans), t_valid)
    popped = ~r_valid & (sp > 0)
    top, st.sp = _pop(st.stack, sp, popped)
    refl = item(so.refl)
    st.active = r_valid | popped
    sel, act = r_valid[..., None], st.active[..., None]
    st.o = torch.where(act, torch.where(sel, refl["o"], top["o"]), tb.center)
    st.d = torch.where(act, torch.where(sel, refl["d"], top["d"]),
                       torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                                    device=st.o.device))
    st.scale = torch.where(sel, refl["scale"], top["scale"])
    st.depth = torch.where(r_valid, refl["depth"], top["depth"])
    st.spec = torch.where(r_valid, refl["spec"], top["spec"])
    st.t_max = torch.where(st.active, F32_MAX, 0.0).to(torch.float32)
    st.pending = st.active | (st.sp > 0)


# --------------------------------------------------------------------
# The kernels' wrappers
# --------------------------------------------------------------------


class _Args(ctypes.Structure):
    """``WhittedArgs`` of csrc/whitted_fused.cu, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "trs", "mat", "lt", "sp", "texels", "tex_off", "tex_w", "tex_h",
        "consts",
        "o", "d", "t_max", "scale", "depth", "spec", "active", "radiance",
        "ray_count", "sptr", "pending",
        "st_o", "st_d", "st_scale", "st_depth", "st_spec",
        "t", "prim", "b0", "b1", "draws",
        "ph", "no", "nd", "nt", "nc", "emit", "refl", "trans", "lane", "occ",
    )] + [(name, ctypes.c_int) for name in (
        "n", "n_lights", "n_spheres", "flags", "depth_cap", "size", "dim0",
    )]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _args(tb: WhittedTables, st: WhittedState, **kw) -> _Args:
    tex = tb.data.textures
    a = _Args()
    for name, t in (("trs", tb.trs), ("mat", tb.mat), ("lt", tb.lt),
                    ("sp", tb.sp), ("texels", tex.texels),
                    ("tex_off", tex.offset), ("tex_w", tex.width),
                    ("tex_h", tex.height), ("consts", tb.consts),
                    ("o", st.o), ("d", st.d), ("t_max", st.t_max),
                    ("scale", st.scale), ("depth", st.depth),
                    ("spec", st.spec), ("active", st.active),
                    ("radiance", st.radiance), ("ray_count", st.ray_count),
                    ("sptr", st.sp), ("pending", st.pending),
                    ("st_o", st.stack["o"]), ("st_d", st.stack["d"]),
                    ("st_scale", st.stack["scale"]),
                    ("st_depth", st.stack["depth"]),
                    ("st_spec", st.stack["spec"])):
        setattr(a, name, _ptr(t))
    for name, t in kw.items():
        setattr(a, name, _ptr(t) if isinstance(t, torch.Tensor) else t)
    a.n = st.o.shape[0]
    a.n_lights = tb.n_lights
    a.n_spheres = tb.n_spheres
    a.flags = tb.flags
    a.depth_cap = tb.depth_cap
    a.size = tb.size
    return a


def _check_state(tb: WhittedTables, st: WhittedState) -> None:
    n, dev, size = st.o.shape[0], st.o.device, tb.size
    f32, i32, b = torch.float32, torch.int32, torch.bool
    tex = tb.data.textures
    for name, t, dtype, shape in (
            ("trs", tb.trs, f32, (tb.trs.shape[0], 32)),
            ("mat", tb.mat, f32, (tb.mat.shape[0], 16)),
            ("lt", tb.lt, f32, (tb.lt.shape[0], 32)),
            ("sp", tb.sp, f32, (max(tb.n_spheres, 1), 40)),
            ("texels", tex.texels, f32, (tex.texels.shape[0], 3)),
            ("tex_off", tex.offset, i32, tuple(tex.offset.shape)),
            ("tex_w", tex.width, i32, tuple(tex.offset.shape)),
            ("tex_h", tex.height, i32, tuple(tex.offset.shape)),
            ("consts", tb.consts, f32, (8,)),
            ("o", st.o, f32, (n, 3)), ("d", st.d, f32, (n, 3)),
            ("t_max", st.t_max, f32, (n,)), ("scale", st.scale, f32, (n, 3)),
            ("depth", st.depth, i32, (n,)), ("spec", st.spec, b, (n,)),
            ("active", st.active, b, (n,)),
            ("radiance", st.radiance, f32, (n, 3)),
            ("ray_count", st.ray_count, i32, (n,)), ("sp", st.sp, i32, (n,)),
            ("pending", st.pending, b, (n,)),
            ("stack o", st.stack["o"], f32, (size, n, 3)),
            ("stack d", st.stack["d"], f32, (size, n, 3)),
            ("stack scale", st.stack["scale"], f32, (size, n, 3)),
            ("stack depth", st.stack["depth"], i32, (size, n)),
            ("stack spec", st.stack["spec"], b, (size, n))):
        _build.check(t, name, dtype, shape, dev)


def whitted_shade(tb: WhittedTables, st: WhittedState, tri_hit, dim0: int,
                  draws=None, ph=None) -> ShadeOut:
    """The shade kernel on CUDA lanes, its plain twin on CPU ones."""
    if not _build.dispatch(st.o):
        return whitted_shade_plain(tb, st, tri_hit, dim0, draws, ph)
    n, dev, L = st.o.shape[0], st.o.device, tb.n_lights
    _check_state(tb, st)
    t, prim, b0, b1 = tri_hit
    for name, x, dtype in (("t", t, torch.float32), ("prim", prim, torch.int32),
                           ("b0", b0, torch.float32),
                           ("b1", b1, torch.float32)):
        _build.check(x, name, dtype, (n,), dev)
    if draws is not None:
        _build.check(draws, "draws", torch.float32, (2 * L, n), dev)
    elif L:
        _build.check(ph, "ph", torch.int32, (n,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    so = ShadeOut(no=torch.empty((L * n, 3), **f32),
                  nd=torch.empty((L * n, 3), **f32),
                  nt=torch.empty(L * n, **f32),
                  nc=torch.empty((L * n, 3), **f32),
                  emit=torch.empty((n, 3), **f32),
                  refl=torch.empty((n, 9), **f32),
                  trans=torch.empty((n, 9), **f32),
                  lane=torch.empty(n, dtype=torch.uint8, device=dev))
    if n:
        a = _args(tb, st, t=t, prim=prim, b0=b0, b1=b1, draws=draws,
                  no=so.no, nd=so.nd, nt=so.nt, nc=so.nc, emit=so.emit,
                  refl=so.refl, trans=so.trans, lane=so.lane, dim0=int(dim0),
                  ph=ph if draws is None else None)
        err = _build.library().yk_whitted_shade(dev.index, ctypes.byref(a),
                                                _build.stream(dev))
        _build.launch_check(err, "whitted_shade")
        _build.bump(LAUNCHES, "whitted_shade")
    return so


def whitted_resolve(tb: WhittedTables, st: WhittedState, so: ShadeOut,
                    occ) -> None:
    """The resolve kernel on CUDA lanes (``st`` rewritten in place), its
    plain twin on CPU ones."""
    if not _build.dispatch(st.o):
        return whitted_resolve_plain(tb, st, so, occ)
    n, dev, L = st.o.shape[0], st.o.device, tb.n_lights
    _check_state(tb, st)
    f32 = torch.float32
    for name, x, dtype, shape in (
            ("no", so.no, f32, (L * n, 3)), ("nd", so.nd, f32, (L * n, 3)),
            ("nt", so.nt, f32, (L * n,)), ("nc", so.nc, f32, (L * n, 3)),
            ("emit", so.emit, f32, (n, 3)), ("refl", so.refl, f32, (n, 9)),
            ("trans", so.trans, f32, (n, 9)),
            ("lane", so.lane, torch.uint8, (n,)),
            ("occ", occ, torch.bool, (L * n,))):
        _build.check(x, name, dtype, shape, dev)
    if n:
        a = _args(tb, st, no=so.no, nd=so.nd, nt=so.nt, nc=so.nc,
                  emit=so.emit, refl=so.refl, trans=so.trans, lane=so.lane,
                  occ=occ)
        err = _build.library().yk_whitted_resolve(dev.index, ctypes.byref(a),
                                                  _build.stream(dev))
        _build.launch_check(err, "whitted_resolve")
        _build.bump(LAUNCHES, "whitted_resolve")
