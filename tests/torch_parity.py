"""Shared helpers for the tests that hold the PyTorch port (yuki_tpu_torch)
against the JAX package: scene leaves through numpy, the JAX wave's
tables, the two small test scenes built with either package, and the
chaos-aware render bounds.  Imports JAX; the port's CUDA-only tests
(test_torch_cuda.py) do not use this module."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import jax.numpy as jnp

from torch_scenes import REDUCED, lightless, sun_sphere, textured_treelet

RES = (64, 48)
TD = 8
TILES = 12
ORIGINS = np.stack(
    [np.arange(TILES, dtype=np.int32) % 4 * TD,
     np.arange(TILES, dtype=np.int32) // 4 * TD], axis=1,
)

SCENE_GROUPS = ("tris", "spheres", "materials", "lights", "textures")


def jax_leaves(scene) -> dict:
    """The JAX SceneData's leaves as numpy, keyed by dotted field path
    (the bridge's format), with the treelet and chunk structures (rows:
    the first 12 columns of tris_padded) and the host BVH."""
    d = scene.data
    out = {}
    for group in SCENE_GROUPS:
        obj = getattr(d, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f"{group}.{f.name}"] = None if v is None else np.asarray(v)
    for k in ("background", "world_lo", "world_hi"):
        out[k] = np.asarray(getattr(d, k))
    for group in ("treelets", "chunks"):
        tl = getattr(d, group)
        if tl is None:
            continue
        out[f"{group}.super_bounds"] = np.asarray(tl.super_bounds)
        out[f"{group}.super_range"] = np.asarray(tl.super_range)
        out[f"{group}.treelet_bounds"] = np.asarray(tl.treelet_bounds)
        out[f"{group}.rows"] = np.asarray(tl.tris_padded)[:, :12]
        for k in ("leaf_size", "n_supers", "n_treelets", "ts_max"):
            out[f"{group}.{k}"] = getattr(tl, k)
    if scene.bvh_host is not None:
        for f in dataclasses.fields(scene.bvh_host):
            out[f"bvh.{f.name}"] = getattr(scene.bvh_host, f.name)
    return out


def jax_native_bvh() -> None:
    """Make sure yuki_tpu builds its BVHs with its native library.

    yuki_tpu compiles that library with g++ at first use into its package
    directory; when several test workers do so at once, one may load a
    half-written file, after which that process silently uses yuki_tpu's
    numpy builder, whose trees differ from the native ones (and so from
    the port's).  Retry the load until it succeeds."""
    from yuki_tpu import native

    for _ in range(60):
        if native.get_lib() is not None:
            return
        native._tried = False
        time.sleep(1.0)
    raise RuntimeError("yuki_tpu's native BVH library does not load")


def bridged(scene):
    """The port's Scene on the CPU, built from a JAX scene's leaves."""
    from yuki_tpu_torch import bridge

    return bridge.scene_from_numpy(
        jax_leaves(scene), dataclasses.asdict(scene.meta), device="cpu"
    )


# --- test scenes built the same way with either package -------------------


def pointspot(sd, tf, cam_mod, **build):
    """test_path_fused.py's point + spot light scene (sigma matte, no
    texture).  sd/tf/cam_mod: the package's scene.data, transforms and
    camera modules."""
    b = sd.SceneBuilder("pointspot")
    m = b.add_matte(kd=(0.6, 0.5, 0.4), sigma=0.3)
    s = 20.0
    b.add_mesh(
        tf.translation((0.0, 0.0, 0.0)),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        np.array([[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]],
                 np.float32),
        material=m,
    )
    b.add_point_light(tf.translation((1.0, 0.0, 3.0)), (9.0, 8.0, 7.0))
    b.add_spot_light(
        tf.translation((-1.0, 0.5, 4.0)), (20.0, 20.0, 22.0),
        total_width_deg=40.0, falloff_start_deg=20.0,
    )
    cam = cam_mod.CameraParameters(
        position=(0.0, 0.0, 6.0), target=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(60.0),
    )
    return b.build(**build), cam


def midsize(sd, tf, cam_mod, **build):
    """test_path_fused.py's >64-triangle dense scene: displaced sheet,
    box, brass sphere, rect area light."""
    from yuki_tpu.scene.testscenes import _box, _bumpy_sheet

    b = sd.SceneBuilder("midsize")
    stone = b.add_matte(kd=(0.5, 0.5, 0.45), sigma=0.25)
    red = b.add_matte(kd=(0.5, 0.1, 0.08))
    brass = b.add_metal(
        eta=(0.44, 0.57, 1.33), k=(3.9, 2.45, 1.8), roughness=0.15,
        remap_roughness=True,
    )
    sp, si = _bumpy_sheet(8.0, 8.0, 8, 8, 0.35, seed=5)  # 128 tris
    b.add_mesh(tf.translation((0.0, -1.0, 0.0)), si, sp, material=stone)
    bp, bi = _box(1.2, 1.2, 1.2)  # 12 tris
    b.add_mesh(tf.translation((-1.5, -0.4, 0.0)), bi, bp, material=red)
    b.add_sphere(tf.translation((1.3, -0.3, 0.5)), 0.7, brass)
    light = b.add_rect_light(
        tf.translation((0.0, 3.0, 0.0)), (30.0, 28.0, 26.0), (2.0, 2.0)
    )
    lp = np.array(
        [[-1.0, 3.0, -1.0], [1.0, 3.0, -1.0], [1.0, 3.0, 1.0],
         [-1.0, 3.0, 1.0]],
        np.float32,
    )
    black = b.add_matte(kd=(0.0, 0.0, 0.0))
    b.add_mesh(tf.Transform.identity(), [0, 2, 1, 0, 3, 2], lp,
               material=black, area_light=light)
    cam = cam_mod.CameraParameters(
        position=(0.0, 1.2, 7.0), target=(0.0, -0.3, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(55.0),
    )
    return b.build(**build), cam


def lit_soup(sd, tf, cam_mod, **build):
    """tests/test_torch_path_li.py's _soup_scene(2000): 2000 random
    triangles in [-2, 2]^3, a dense scene past the fused wave's
    1024-triangle gate, with its point light moved between the camera and
    the soup (above it, the tangle shadows every visible point)."""
    rng = np.random.default_rng(0)
    n = 2000
    b = sd.SceneBuilder("soup")
    m = b.add_matte(kd=(0.5, 0.5, 0.5))
    pts = (rng.random((3 * n, 3)) * 4 - 2).astype(np.float32)
    b.add_mesh(tf.Transform.identity(), np.arange(3 * n), pts, material=m)
    b.add_point_light(tf.translation((0.5, 1.0, 4.0)), (8.0, 8.0, 8.0))
    cam = cam_mod.CameraParameters(
        position=(0.0, 0.5, 6.0), target=(0.0, 0.0, 0.0),
        up=(0.0, 1.0, 0.0), fov=cam_mod.FoV.x(50.0),
    )
    return b.build(**build), cam


def soup_triangles(n_tris=300, seed=7) -> np.ndarray:
    """tests/test_treelets.py's triangle soup: [n,3,3] f32."""
    rng = np.random.default_rng(seed)
    base = (rng.random((n_tris, 1, 3)) - 0.5) * 6
    return (base + rng.standard_normal((n_tris, 3, 3)) * 0.25).astype(
        np.float32)


def soup(sd, tf, **build):
    """The soup as a scene, one mesh per triangle, as test_treelets.py
    builds it (sah, four shapes per leaf)."""
    if sd.__name__.startswith("yuki_tpu."):
        jax_native_bvh()
    b = sd.SceneBuilder()
    m = b.add_matte()
    for t in soup_triangles():
        b.add_mesh(tf.Transform.identity(), [0, 1, 2], t, material=m)
    return b.build(split_method="sah", max_shapes_in_node=4, **build)


def soup_scenes(n_tris, seed, lit=False):
    """(JAX scene, port scene on the CPU) of soup_triangles(n_tris, seed),
    one mesh per triangle, sah with four shapes per leaf (tests/
    test_stream.py's soup); ``lit``: the second half of the triangles
    carry area-light id 0, as tests/test_combined.py's soup."""
    from yuki_tpu import transforms as jtf
    from yuki_tpu.scene import data as jdata
    from yuki_tpu_torch import transforms as tf
    from yuki_tpu_torch.scene import data as tdata

    jax_native_bvh()
    out = []
    for sd, tfm, build in ((jdata, jtf, {}), (tdata, tf, {"device": "cpu"})):
        b = sd.SceneBuilder("soup")
        m = b.add_matte(kd=(0.7, 0.6, 0.5))
        for i, t in enumerate(soup_triangles(n_tris, seed)):
            b.add_mesh(tfm.Transform.identity(), [0, 1, 2], t, material=m,
                       area_light=0 if lit and i >= n_tris // 2 else -1)
        out.append(b.build(split_method="sah", max_shapes_in_node=4,
                           **build))
    return tuple(out)


def chunk_soup(n_tris, seed, leaf_size, light=None):
    """A soup's flat chunk cut (supers == chunks, as the scene builder cuts
    chunks) built by either package: (JAX scene, JAX chunks, port scene,
    port chunks).  ``light``: [n_tris] i32 area-light ids for the chunk
    rows in place of the scene's (all -1)."""
    from yuki_tpu.treelets import build_treelets as jax_build_treelets
    from yuki_tpu_torch.treelets import build_treelets

    jsc, tsc = soup_scenes(n_tris, seed)
    tri = np.stack([np.asarray(jsc.data.tris.p0), np.asarray(jsc.data.tris.p1),
                    np.asarray(jsc.data.tris.p2)], axis=1)
    if light is None:
        light = np.asarray(jsc.data.tris.area_light)
    jch = jax_build_treelets(jsc.bvh_host, tri, light, leaf_size=leaf_size,
                             super_size=leaf_size)
    tch = build_treelets(tsc.bvh_host, tri, light, leaf_size=leaf_size,
                         super_size=leaf_size, device="cpu")
    return jsc, jch, tsc, tch


def divergent_rays(n, seed, boxes=None, span=6.0):
    """n rays with origins in [-span/2, span/2]^3 and random unit
    directions; with ``boxes`` ([K, >=3] box rows), an eighth are
    axis-parallel (direction components exactly 0) from box lo corners,
    the slab tests' 0 * inf case."""
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3), np.float32) - 0.5) * span).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if boxes is not None:
        q = n // 8
        axis = rng.integers(0, 3, q)
        d[:q] = 0.0
        d[np.arange(q), axis] = rng.choice([-1.0, 1.0], q)
        o[:q] = boxes[rng.integers(0, boxes.shape[0], q), :3]
    return o, d


SCENE_BUILDERS = {"pointspot": pointspot, "midsize": midsize,
                  "textured-treelet": textured_treelet, "lit-soup": lit_soup,
                  "sun-sphere": sun_sphere, "lightless": lightless}


def jax_scene(name):
    """(JAX scene, JAX camera params) for 'cornell', 'colonnade',
    'reduced' or a name of SCENE_BUILDERS."""
    from yuki_tpu import camera, transforms
    from yuki_tpu.scene import data
    from yuki_tpu.scene.cornell import cornell

    jax_native_bvh()
    if name == "cornell":
        scene, cam, _ = cornell()
        return scene, cam
    if name in ("colonnade", "reduced"):
        from yuki_tpu.scene.testscenes import colonnade

        scene, cam, _ = colonnade(**(REDUCED if name == "reduced" else {}))
        return scene, cam
    return SCENE_BUILDERS[name](data, transforms, camera)


def port_scene(name):
    """(port scene on the CPU, port camera params) for the same names."""
    from yuki_tpu_torch import camera, transforms
    from yuki_tpu_torch.scene import data
    from yuki_tpu_torch.scene.cornell import cornell

    if name == "cornell":
        scene, cam, _ = cornell(device="cpu")
        return scene, cam
    if name in ("colonnade", "reduced"):
        from yuki_tpu_torch.scene.testscenes import colonnade

        scene, cam, _ = colonnade(
            device="cpu", **(REDUCED if name == "reduced" else {}))
        return scene, cam
    return SCENE_BUILDERS[name](data, transforms, camera, device="cpu")


# --- the JAX wave's tables (yuki_tpu path_fused.path_li_wave:1053-1097) ---


def jax_wave_tables(scene, camera, indirect_clamp=None) -> dict:
    """The tables and statics path_li_wave hands its kernels, built with
    the JAX package's own helpers, for calling _raygen_values and
    _bounce_values on plain arrays."""
    from yuki_tpu.ops import path_fused as jpf
    from yuki_tpu.ops.trace import pack_triangles

    data, meta = scene.data, scene.meta
    r2c = jnp.asarray(camera.raster_to_camera, jnp.float32).reshape(16)
    c2w = jnp.asarray(camera.camera_to_world, jnp.float32).reshape(16)
    center = 0.5 * (data.world_lo + data.world_hi)
    diag = jnp.linalg.norm(data.world_hi - data.world_lo) * 1.002 + 1e-3
    clamp_v = 0.0 if indirect_clamp is None else indirect_clamp
    ms = jnp.zeros(128)
    ms = ms.at[0:16].set(r2c).at[16:32].set(c2w).at[32:35].set(center)
    ms = ms.at[35].set(diag).at[36:39].set(
        jnp.asarray(data.background, jnp.float32))
    ms = ms.at[39].set(jnp.float32(clamp_v)).reshape(1, 128)
    n_tris = meta.n_tris
    trs = data.tris.shading_packed
    mat = data.materials.packed
    has_tex = bool(meta.has_textures)
    pal_colors = int(meta.texpool_palette) if has_tex else 0
    pal = jnp.zeros((8, 128), jnp.float32)
    if has_tex and pal_colors:
        td, _, pool_pad = jpf._tex_tables(data.textures, meta.texpool_texels)
        tex, pal, pool_pad = jpf._tex_tables_pal(data.textures,
                                                 meta.texpool_texels)
    elif has_tex:
        td, tex, pool_pad = jpf._tex_tables(data.textures,
                                            meta.texpool_texels)
    else:
        td = jnp.zeros((1, 4))
        tex = jnp.zeros((768, 8), jnp.bfloat16)
        pool_pad = 8 * 256
    return dict(
        ms=ms,
        tri=pack_triangles(data.tris.p0, data.tris.p1, data.tris.p2),
        trs=trs,
        trb=jpf._byte_table(trs[:, :32], max(8, -(-n_tris // 8) * 8)),
        matb=jpf._byte_table(mat[:, :11],
                             max(8, -(-mat.shape[0] // 8) * 8)),
        lt=jpf._light_table(data.lights),
        sp=jpf._sphere_table(data.spheres, meta.n_spheres),
        td=td, tex=tex, pal=pal,
        statics=dict(
            n_tris=n_tris, n_spheres=meta.n_spheres,
            n_lights=len(meta.light_types),
            light_types=tuple(meta.light_types),
            present=frozenset(meta.material_types),
            has_sigma=bool(meta.has_sigma or meta.has_sigma_tex),
            has_clamp=indirect_clamp is not None, has_tex=has_tex,
            pool_pad=pool_pad, pal_colors=pal_colors,
        ),
    )


# --- Pallas kernels evaluated op by op -----------------------------------


class _PlanesOut:
    """An output ref that collects ``out_ref[i] = plane`` writes."""

    def __init__(self, shape):
        self.shape = shape
        self.planes = [None] * shape[0]

    def __setitem__(self, i, v):
        self.planes[i] = v

    def value(self):
        return jnp.stack([jnp.broadcast_to(p, self.shape[1:])
                          for p in self.planes])


def _eager_pallas_call(kernel, grid_spec=None, out_shape=(), interpret=False,
                       **_):
    """pallas_call for kernels that write whole planes (out_ref[i] = ...):
    the kernel body runs once over the full arrays, op by op."""
    def call(*args):
        outs = [_PlanesOut(o.shape) for o in out_shape]
        kernel(*args, *outs)
        return [o.value() for o in outs]
    return call


@contextlib.contextmanager
def eager_pallas():
    """Run yuki_tpu's plane kernels (shade_fused) eagerly, op by op,
    instead of through Pallas interpret mode, which XLA compiles: under
    jit XLA contracts a*b + c into FMAs, which the port (and its CUDA
    kernels, built with -fmad=false) do not.  This is how the dense-wave
    tests call path_fused's kernel bodies."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = _eager_pallas_call
    try:
        yield
    finally:
        pl.pallas_call = orig


class _GridRef:
    """A kernel ref over a numpy block: reads give jnp arrays, writes land
    in the block (a view of the call's output for output refs)."""

    def __init__(self, arr):
        self.arr = arr
        self.shape = arr.shape
        self.dtype = arr.dtype

    @staticmethod
    def _index(idx):
        from jax._src.state.indexing import Slice

        idx = idx if isinstance(idx, tuple) else (idx,)
        return tuple(slice(int(i.start), int(i.start) + int(i.size))
                     if isinstance(i, Slice) else i for i in idx)

    def __getitem__(self, idx):
        return jnp.asarray(self.arr[self._index(idx)])

    def __setitem__(self, idx, v):
        self.arr[self._index(idx)] = np.asarray(v)


_GRID_AT = [0]  # the grid step a kernel body runs at, for pl.program_id


def _grid_pallas_call(kernel, out_shape=(), *, grid_spec=None, **_):
    """pallas_call for grid kernels with scalar prefetch (trace_stream's
    slot walks, trace_rows' row walks): every grid step runs the kernel
    body op by op on its blocks, cut by the BlockSpecs' index maps."""
    import itertools

    def call(*args):
        nsp = grid_spec.num_scalar_prefetch
        scalars = [np.asarray(a) for a in args[:nsp]]
        ins = [np.asarray(a) for a in args[nsp:]]
        outs = [np.zeros(o.shape, o.dtype) for o in out_shape]

        def block(spec, arr, p):
            at = spec.index_map(*p, *scalars)
            return arr[tuple(slice(int(i) * b, (int(i) + 1) * b)
                             for i, b in zip(at, spec.block_shape))]

        for p in itertools.product(*(range(g) for g in grid_spec.grid)):
            _GRID_AT[:] = p
            refs = [_GridRef(s) for s in scalars]
            refs += [_GridRef(block(s, a, p).copy())
                     for s, a in zip(grid_spec.in_specs, ins)]
            refs += [_GridRef(block(s, a, p))
                     for s, a in zip(grid_spec.out_specs, outs)]
            kernel(*refs)
        return [jnp.asarray(o) for o in outs]
    return call


@contextlib.contextmanager
def eager_grid_pallas():
    """Run yuki_tpu's grid kernels (trace_stream._closest_kernel,
    _any_kernel, trace_rows._rows_closest_kernel, _rows_any_kernel,
    trace_walker._walker_closest_kernel, _walker_any_kernel) step by step
    and op by op, as eager_pallas runs the plane kernels: pl.pallas_call
    walks the grid in Python, and pl.when, jax.lax.fori_loop,
    jax.lax.while_loop, jax.lax.map (the rows' and the walker's segments)
    and jax.lax.cond (the walker's budget tiers) become Python control
    flow over concrete values.  The slot-stream tests call the stream
    functions with one slot-budget tier (mult_wide None)."""
    import jax
    from jax.experimental import pallas as pl

    def when(cond):
        return lambda fn: fn() if bool(cond) else None

    def cond(pred, true_fn, false_fn, *operands):
        return (true_fn if bool(pred) else false_fn)(*operands)

    def fori_loop(lo, hi, body, val):
        for i in range(int(lo), int(hi)):
            val = body(i, val)
        return val

    def while_loop(cond, body, val):
        while bool(cond(val)):
            val = body(val)
        return val

    def lax_map(fn, xs):
        outs = [fn(jax.tree_util.tree_map(lambda x, i=i: x[i], xs))
                for i in range(jax.tree_util.tree_leaves(xs)[0].shape[0])]
        return jax.tree_util.tree_map(lambda *v: jnp.stack(v), *outs)

    saved = (pl.pallas_call, pl.when, pl.program_id, jax.lax.fori_loop,
             jax.lax.while_loop, jax.lax.map, jax.lax.cond)
    pl.pallas_call, pl.when = _grid_pallas_call, when
    pl.program_id = lambda axis: _GRID_AT[axis]
    jax.lax.fori_loop, jax.lax.while_loop = fori_loop, while_loop
    jax.lax.map, jax.lax.cond = lax_map, cond
    try:
        yield
    finally:
        (pl.pallas_call, pl.when, pl.program_id, jax.lax.fori_loop,
         jax.lax.while_loop, jax.lax.map, jax.lax.cond) = saved


# --- chaos-aware render bounds (tests/test_path_fused.py:58-81) ----------


def assert_parity(ref, rays_ref, got, rays_got, depth, spp=1,
                  rtol_shallow=2e-6):
    """test_path_fused.py's _assert_parity, restated: depth <= 2 renders
    agree to rtol 2e-6 / atol 1e-7 with equal ray counts; deeper renders,
    where ulp-level differences flip a few borderline intersection, glass
    and roulette decisions by design, must keep the ray count within 1%
    (or 16), the divergent pixels (error > 2e-4 + 2e-4|ref|) within 1/12
    (or 4), and the mean within rtol 2e-3.  ``rays_ref`` None skips the
    ray-count check (a golden image carries no count).

    ``spp`` > 1 compares spp-sample averages: the 1/12 bound is per
    sample, and a pixel diverges when any of its samples does, so the
    bound becomes 1 - (11/12)^spp.  (Calibration at 8 spp, Cornell 64x48
    depth 4 against the committed golden: yuki_tpu's own fused wave
    diverges on 570 of 3072 pixels, 18.6%; the bound is 50%.)

    ``rtol_shallow`` replaces the depth <= 2 rtol where the reference
    was compiled by XLA and the other side was not (see
    test_torch_wave.py)."""
    if depth <= 2:
        if rays_ref is not None:
            assert rays_ref == rays_got
        np.testing.assert_allclose(got, ref, rtol=rtol_shallow, atol=1e-7)
    else:
        if rays_ref is not None:
            assert abs(rays_ref - rays_got) <= max(16, rays_ref * 0.01)
        bad = np.abs(got - ref) > 2e-4 + 2e-4 * np.abs(ref)
        n_px = bad.reshape(-1, 3).shape[0]
        n_bad = int(bad.reshape(-1, 3).any(axis=-1).sum())
        limit = max(4, int(n_px * (1.0 - (11.0 / 12.0) ** spp)))
        assert n_bad <= limit, f"{n_bad} divergent pixels of {n_px}"
        np.testing.assert_allclose(got.mean(), ref.mean(), rtol=2e-3)


# --- whole waves ---------------------------------------------------------


@contextlib.contextmanager
def jax_dense_kernels():
    """Make yuki_tpu's dense queries (traverse.intersect_dense,
    any_intersect_dense) run its Pallas dense kernels (ops/trace.py
    dense_trace, dense_trace_skip, any_trace) in interpret mode, as they
    run on the TPU, instead of its CPU sweep over intersect.ray_triangle,
    whose t_scaled associates differently (e0 * (p0z * sz) + ... against
    the kernels' (e0 * p0z + ...) * inv_dz)."""
    import functools

    from yuki_tpu import traverse as jtr
    from yuki_tpu.ops import trace as jtrace

    names = ("dense_trace", "dense_trace_skip", "any_trace")
    saved = jtr._backend_tpu, [getattr(jtrace, k) for k in names]
    jtr._backend_tpu = lambda: True
    for k, fn in zip(names, saved[1]):
        setattr(jtrace, k, functools.partial(fn, interpret=True))
    try:
        yield
    finally:
        jtr._backend_tpu = saved[0]
        for k, fn in zip(names, saved[1]):
            setattr(jtrace, k, fn)


def samplers(strat=None, spp=1):
    """(JAX sampler, port sampler): UniformSampler(spp), or
    StratifiedSampler(*strat) on both sides."""
    from yuki_tpu import sampling as js
    from yuki_tpu_torch import sampling as ts

    if strat is None:
        return js.UniformSampler(spp), ts.UniformSampler(spp)
    return js.StratifiedSampler(*strat), ts.StratifiedSampler(*strat)


def render_path_li_both(name, depth, seed=7, strat=None):
    """One 12-tile wave of a scene's 64x48 film through JAX's
    make_wave_renderer with the fused shade kernels in Pallas interpret
    mode and the fused wave off (on the CPU JAX traverses a treelet scene
    with intersect_bvh, a dense one with its dense Pallas kernels in
    interpret mode: jax_dense_kernels) and through the port's
    make_wave_renderer on the CPU with the fused wave off (path_li over
    the plain dispatch or dense sweeps, shade and resolve), with
    UniformSampler(1) or StratifiedSampler(*strat).  Returns (ref,
    rays_ref, got, rays_got)."""
    from yuki_tpu import integrators as jintg
    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.ops import path_fused as jpf
    from yuki_tpu.renderer import make_wave_renderer as jax_mwr
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.renderer import make_wave_renderer

    jsam, tsam = samplers(strat)
    jscene, jcam = jax_scene(name)
    old = jintg.FUSED_SHADE_MODE, jpf.PATH_FUSED_MODE
    jintg.FUSED_SHADE_MODE, jpf.PATH_FUSED_MODE = "interpret", "off"
    try:
        render = jax_mwr(jscene, JCamera.create(jcam, *RES), jsam,
                         jintg.PathParams(max_depth=depth), TD, TILES)
        with jax_dense_kernels():
            px, rays = render(jnp.asarray(ORIGINS), jnp.int32(0),
                              jnp.uint32(seed))
        ref, rays_ref = np.asarray(px), float(rays)
    finally:
        jintg.FUSED_SHADE_MODE, jpf.PATH_FUSED_MODE = old
    tscene, tcam = port_scene(name)
    old = tpf.PATH_FUSED_MODE
    tpf.PATH_FUSED_MODE = "off"
    try:
        render = make_wave_renderer(tscene, Camera.create(tcam, *RES),
                                    tsam, PathParams(max_depth=depth), TD,
                                    TILES)
        px, rays = render(ORIGINS, 0, seed)
    finally:
        tpf.PATH_FUSED_MODE = old
    return ref, rays_ref, px.numpy(), float(rays)


def path_li_golden_jax(scene, cam_params, w=64, h=48, depth=3, seed=1):
    """A JAX scene at w x h, ``depth``, 1 spp (UniformSampler), ``seed``,
    rendered by yuki_tpu's XLA path_li chain on the CPU
    (FUSED_SHADE_MODE "off"): [h, w, 3] f32."""
    from yuki_tpu import integrators as jintg
    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.sampling import SampleCtx, UniformSampler as JUniform

    cam = JCamera.create(cam_params, w, h)
    px, py = jnp.meshgrid(jnp.arange(w, dtype=jnp.int32),
                          jnp.arange(h, dtype=jnp.int32), indexing="xy")
    px, py = px.reshape(-1), py.reshape(-1)
    ctx = SampleCtx(px=px, py=py, sample_index=jnp.uint32(0),
                    seed=jnp.uint32(seed))
    sampler = JUniform(1)
    u = sampler.get_2d(ctx, 0)
    o, d = cam.ray(jnp.stack([px.astype(jnp.float32),
                              py.astype(jnp.float32)], -1) + u)
    old = jintg.FUSED_SHADE_MODE
    jintg.FUSED_SHADE_MODE = "off"
    try:
        res = jintg.path_li(scene.data, scene.meta, jintg.PathParams(depth),
                            sampler, ctx, o, d)
    finally:
        jintg.FUSED_SHADE_MODE = old
    return np.asarray(res.li).reshape(h, w, 3)


def colonnade_golden_jax():
    """The colonnade at 64x48, depth 3, 1 spp, seed 1, rendered by
    yuki_tpu's XLA path_li chain on the CPU (FUSED_SHADE_MODE "off"):
    the image of tests/goldens/torch_colonnade_64x48_path3_1spp_seed1.npz,
    [48, 64, 3] f32."""
    scene, cam_params = jax_scene("colonnade")
    return path_li_golden_jax(scene, cam_params)


def atrium_golden_jax(out_dir, small):
    """The small (1,024 triangles) or full (347,136) atrium, written by
    tools/make_atrium_assets.py into ``out_dir``, loaded by yuki_tpu's
    load_pbrt and rendered like the colonnade golden: the image of
    tests/goldens/torch_atrium_small_64x48_path3_1spp_seed1.npz or
    tests/goldens/torch_atrium_64x48_path3_1spp_seed1.npz."""
    import os
    import sys

    from yuki_tpu.app.settings import SceneLoadSettings
    from yuki_tpu.scene.pbrt import load_pbrt

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from make_atrium_assets import write_scene

    jax_native_bvh()
    write_scene(str(out_dir), small=small)
    scene, cam_params, _ = load_pbrt(
        SceneLoadSettings(path=os.path.join(str(out_dir), "atrium.pbrt")))
    return path_li_golden_jax(scene, cam_params)


def render_both(depth, spp=1, clamp=None, spl=1, seed=7, strat=None):
    """One 12-tile wave of the 64x48 Cornell film through JAX's
    make_wave_renderer in Pallas interpret mode (the fused wave's
    kernels, run by the interpreter) and through the port's
    make_wave_renderer on the CPU (the plain versions), with
    UniformSampler(spp) or StratifiedSampler(*strat).  Returns
    (ref, rays_ref, got, rays_got) as numpy pixels and float ray counts."""
    import jax.numpy as jnp

    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.integrators import PathParams as JPathParams
    from yuki_tpu.ops import path_fused as jpf
    from yuki_tpu.renderer import make_wave_renderer as jax_mwr
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import make_wave_renderer

    jsam, tsam = samplers(strat, spp)
    jscene, jcam = jax_scene("cornell")
    old = jpf.PATH_FUSED_MODE
    jpf.PATH_FUSED_MODE = "interpret"
    try:
        # Anti-vacuity: the comparison must run the JAX fused wave.
        assert jpf.use_wave_fused(jscene.meta, jsam)
        render = jax_mwr(
            jscene, JCamera.create(jcam, *RES), jsam,
            JPathParams(max_depth=depth, indirect_clamp=clamp), TD, TILES,
            samples_per_launch=spl,
        )
        px, rays = render(jnp.asarray(ORIGINS), jnp.int32(0),
                          jnp.uint32(seed))
        ref, rays_ref = np.asarray(px), float(rays)
    finally:
        jpf.PATH_FUSED_MODE = old

    tscene, tcam = port_scene("cornell")
    render = make_wave_renderer(
        tscene, Camera.create(tcam, *RES), tsam,
        PathParams(max_depth=depth, indirect_clamp=clamp), TD, TILES,
        samples_per_launch=spl,
    )
    px, rays = render(ORIGINS, 0, seed)
    return ref, rays_ref, px.numpy(), float(rays)


# --- the shading chain's modules, eagerly on both sides ------------------


def chain_inputs(name, n=1024, seed=5):
    """Inputs for holding a shading-chain module against yuki_tpu's: the
    JAX scene, the port's scene from its leaves, and n rays from a numpy
    seed (half camera rays through random points of the 64x48 film, half
    from random points of the scene box in random directions, so that
    back faces and sphere insides are hit) with their closest hits by the
    port's query.  Returns (jscene, tscene, o, d, hit: dict of torch
    tensors)."""
    import torch

    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.camera import Camera

    jscene, _ = jax_scene(name)
    tscene = bridged(jscene)
    _, cam = port_scene(name)
    rng = np.random.default_rng(seed)
    m = n // 2
    p_film = (rng.random((m, 2)) * np.array(RES)).astype(np.float32)
    o_cam, d_cam = Camera.create(cam, *RES).ray(torch.as_tensor(p_film))
    lo = np.asarray(jscene.data.world_lo)
    hi = np.asarray(jscene.data.world_hi)
    o_rnd = (lo + rng.random((n - m, 3)) * (hi - lo)).astype(np.float32)
    d_rnd = rng.standard_normal((n - m, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=1, keepdims=True)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd)]).contiguous()
    d = torch.cat([d_cam, torch.as_tensor(d_rnd)]).contiguous()
    t_max = torch.full((n,), traverse.F32_MAX)
    hit = traverse.intersect(tscene.data, tscene.meta, o, d, t_max)
    return jscene, tscene, o, d, hit._asdict()


def to_jnp(x):
    """A torch tensor, or a NamedTuple or dict of them, as jnp arrays."""
    if isinstance(x, dict):
        return {k: to_jnp(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return type(x)(*(to_jnp(v) for v in x))
    return jnp.asarray(x.numpy())


def xla_fn(fn):
    """A transcendental evaluated by XLA on the CPU, as eager yuki_tpu
    evaluates it, for the port's torch code."""
    import torch

    return lambda *xs: torch.as_tensor(np.array(fn(*(x.numpy() for x in xs))))


def ulps(a, b):
    """Elementwise distance in float32 ulps (0 where both are equal,
    signed zeros included)."""
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)

    def key(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.where(a == b, 0, np.abs(key(a) - key(b)))


def whitted_golden_jax(scene, cam_params, w=64, h=48, depth=3, seed=1):
    """A JAX scene at w x h, Whitted(``depth``), 1 spp (UniformSampler),
    ``seed``, rendered by yuki_tpu's whitted_li on the CPU (a treelet
    scene traverses with yuki_tpu's threaded BVH walk there): [h, w, 3]
    f32."""
    from yuki_tpu import integrators as jintg
    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.sampling import SampleCtx, UniformSampler as JUniform

    cam = JCamera.create(cam_params, w, h)
    px, py = jnp.meshgrid(jnp.arange(w, dtype=jnp.int32),
                          jnp.arange(h, dtype=jnp.int32), indexing="xy")
    px, py = px.reshape(-1), py.reshape(-1)
    ctx = SampleCtx(px=px, py=py, sample_index=jnp.uint32(0),
                    seed=jnp.uint32(seed))
    sampler = JUniform(1)
    u = sampler.get_2d(ctx, 0)
    o, d = cam.ray(jnp.stack([px.astype(jnp.float32),
                              py.astype(jnp.float32)], -1) + u)
    res = jintg.whitted_li(scene.data, scene.meta, jintg.WhittedParams(depth),
                           sampler, ctx, o, d)
    return np.asarray(res.li).reshape(h, w, 3)


def colonnade_whitted_golden_jax():
    """The colonnade at 64x48, Whitted(3), 1 spp, seed 1, rendered by
    yuki_tpu on the CPU: the image of
    tests/goldens/torch_colonnade_64x48_whitted3_1spp_seed1.npz."""
    scene, cam_params = jax_scene("colonnade")
    return whitted_golden_jax(scene, cam_params)
