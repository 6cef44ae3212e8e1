"""The port's debug rays (yuki_tpu_torch/integrators/debug_rays.py) against
yuki_tpu's on Cornell, for a handful of film pixels (the glass box, the
copper sphere, the walls, the light).

The path walk (depth 3) and the Whitted walk (depth 2: the glass box's
reflected and refracted children are traced; a third level would only add
eager JAX compiles for new batch shapes) give each lane the same segment
types in the same order as yuki_tpu's, from the same camera
rays and sampler keys.  Endpoints agree within 1e-5 relative (1e-6
absolute): each hit's t comes from a different route (yuki_tpu's eager
XLA sweep, the port's dense sweep, ROADMAP Queue 3 item 2), and a bounce
after it starts from that point.  ``project_segments`` gives the same
pixels from the port's rays with either package's camera.
"""

import numpy as np
import pytest
import torch

from yuki_tpu_torch.camera import Camera
from yuki_tpu_torch.integrators import PathParams
from yuki_tpu_torch.integrators import debug_rays as dr
from yuki_tpu_torch.sampling import SampleCtx, UniformSampler
from yuki_tpu_torch.scene.cornell import cornell

torch.set_num_threads(2)

RES = (64, 48)
PIXELS = [(32, 24), (20, 33), (44, 35), (8, 20), (56, 20), (32, 3),
          (26, 40), (40, 30)]


@pytest.fixture(scope="module")
def both():
    """Both packages' walks on the same rays: {walk: (jax lanes, port
    lanes)} and the two cameras."""
    import jax.numpy as jnp

    from yuki_tpu.camera import Camera as JCamera
    from yuki_tpu.integrators import PathParams as JPathParams
    from yuki_tpu.integrators import debug_rays as jdr
    from yuki_tpu.sampling import SampleCtx as JSampleCtx
    from yuki_tpu.sampling import UniformSampler as JUniformSampler
    from yuki_tpu.scene.cornell import cornell as jcornell

    jsc, jcp, _ = jcornell()
    tsc, tcp, _ = cornell(device="cpu")
    cam = Camera.create(tcp, *RES)
    px = np.array([p[0] for p in PIXELS], np.int32)
    py = np.array([p[1] for p in PIXELS], np.int32)
    p_film = torch.as_tensor(np.stack([px + 0.5, py + 0.5], 1)
                             .astype(np.float32))
    o, d = cam.ray(p_film)
    o, d = o.contiguous(), d.contiguous()
    ctx = SampleCtx(px=torch.as_tensor(px), py=torch.as_tensor(py),
                    sample_index=0, seed=0)
    jctx = JSampleCtx(px=jnp.asarray(px, jnp.uint32),
                      py=jnp.asarray(py, jnp.uint32),
                      sample_index=jnp.uint32(0), seed=jnp.uint32(0))
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    out = {}
    for walk, depth in (("path", 3), ("whitted", 2)):
        tfn = dr.collect_debug_rays if walk == "path" else (
            dr.collect_debug_rays_whitted)
        jfn = jdr.collect_debug_rays if walk == "path" else (
            jdr.collect_debug_rays_whitted)
        out[walk] = (
            jfn(jsc.data, jsc.meta, JPathParams(depth), JUniformSampler(1),
                jctx, jo, jd),
            tfn(tsc.data, tsc.meta, PathParams(depth), UniformSampler(1), ctx,
                o, d))
    return out, cam, JCamera.create(jcp, *RES)


@pytest.mark.parametrize("walk", ("path", "whitted"))
def test_segments_match_jax(both, walk):
    lanes, _, _ = both
    jl, tl = lanes[walk]
    assert len(jl) == len(tl) == len(PIXELS)
    kinds = set()
    for j_rays, t_rays in zip(jl, tl):
        assert [r.ray_type for r in t_rays] == [r.ray_type for r in j_rays]
        for jr, trr in zip(j_rays, t_rays):
            for a, b in ((trr.o, jr.o), (trr.end, jr.end)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                           atol=1e-6)
            kinds.add(trr.ray_type)
    assert {"direct", "normal", "shadow", "reflection"} <= kinds
    if walk == "whitted":
        assert "refraction" in kinds  # the glass box's children


def test_project_segments_match_jax(both):
    from yuki_tpu.integrators.debug_rays import project_segments as jproj

    lanes, cam, jcam = both
    for t_rays in lanes["path"][1] + lanes["whitted"][1]:
        got = dr.project_segments(cam, *RES, t_rays)
        want = jproj(jcam, *RES, t_rays)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g["type"] == w["type"] and g["color"] == w["color"]
            for k in ("x0", "y0", "x1", "y1"):
                assert g[k] == pytest.approx(w[k], rel=1e-9, abs=1e-9)


def test_min_length_and_colors(both):
    """Miss and normal segments are the scene's largest extent / 10 long;
    every type has its reference colour."""
    lanes, _, _ = both
    tsc, _, _ = cornell(device="cpu")
    ext = float((tsc.data.world_hi - tsc.data.world_lo).max()) / 10.0
    normals = [r for lane in lanes["path"][1] for r in lane
               if r.ray_type == "normal"]
    assert normals
    for r in normals:
        assert np.linalg.norm(r.end - r.o) == pytest.approx(ext, rel=1e-5)
    assert dr.RAY_COLORS["shadow"] == (1.0, 1.0, 0.0)
