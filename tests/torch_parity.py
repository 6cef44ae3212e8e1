"""Shared helpers for the tests that hold the PyTorch port (yuki_tpu_torch)
against the JAX package: scene leaves through numpy, the JAX wave's
tables, the two small test scenes built with either package, and the
chaos-aware render bounds.  Imports JAX; the port's CUDA-only tests
(test_torch_cuda.py) do not use this module."""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

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
    (the bridge's format); the BVH and treelet pytrees are left out."""
    d = scene.data
    out = {}
    for group in SCENE_GROUPS:
        obj = getattr(d, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f"{group}.{f.name}"] = None if v is None else np.asarray(v)
    for k in ("background", "world_lo", "world_hi"):
        out[k] = np.asarray(getattr(d, k))
    return out


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


def jax_scene(name):
    """(JAX scene, JAX camera params) for 'cornell' | 'pointspot' |
    'midsize'."""
    from yuki_tpu import camera, transforms
    from yuki_tpu.scene import data
    from yuki_tpu.scene.cornell import cornell

    if name == "cornell":
        scene, cam, _ = cornell()
        return scene, cam
    return {"pointspot": pointspot, "midsize": midsize}[name](
        data, transforms, camera
    )


def port_scene(name):
    """(port scene on the CPU, port camera params) for the same names."""
    from yuki_tpu_torch import camera, transforms
    from yuki_tpu_torch.scene import data
    from yuki_tpu_torch.scene.cornell import cornell

    if name == "cornell":
        scene, cam, _ = cornell(device="cpu")
        return scene, cam
    return {"pointspot": pointspot, "midsize": midsize}[name](
        data, transforms, camera, device="cpu"
    )


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


def render_both(depth, spp=1, clamp=None, spl=1, seed=7):
    """One 12-tile wave of the 64x48 Cornell film through JAX's
    make_wave_renderer in Pallas interpret mode (the fused wave's
    kernels, run by the interpreter) and through the port's
    make_wave_renderer on the CPU (the plain versions).  Returns
    (ref, rays_ref, got, rays_got) as numpy pixels and float ray counts."""
    import jax.numpy as jnp

    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.integrators import PathParams as JPathParams
    from yuki_tpu.ops import path_fused as jpf
    from yuki_tpu.renderer import make_wave_renderer as jax_mwr
    from yuki_tpu.sampling import UniformSampler as JUniform
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import make_wave_renderer
    from yuki_tpu_torch.sampling import UniformSampler

    jscene, jcam = jax_scene("cornell")
    old = jpf.PATH_FUSED_MODE
    jpf.PATH_FUSED_MODE = "interpret"
    try:
        # Anti-vacuity: the comparison must run the JAX fused wave.
        assert jpf.use_wave_fused(jscene.meta, JUniform(spp))
        render = jax_mwr(
            jscene, JCamera.create(jcam, *RES), JUniform(spp),
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
        tscene, Camera.create(tcam, *RES), UniformSampler(spp),
        PathParams(max_depth=depth, indirect_clamp=clamp), TD, TILES,
        samples_per_launch=spl,
    )
    px, rays = render(ORIGINS, 0, seed)
    return ref, rays_ref, px.numpy(), float(rays)
