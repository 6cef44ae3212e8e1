"""The port's scene builder (yuki_tpu_torch.scene) against the JAX one:
every table the dense wave reads must hold the same bits, the slice's
SceneMeta facts must agree, and the bridge must rebuild the same scene
from the JAX leaves."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu_torch.scene import data as tdata

torch.set_num_threads(2)

SCENES = ["cornell", "pointspot", "midsize"]

# Leaves the dense wave reads (everything but the BVH/treelet pytrees).
TABLE_LEAVES = [
    "tris.p0", "tris.p1", "tris.p2", "tris.n0", "tris.n1", "tris.n2",
    "tris.uv0", "tris.uv1", "tris.uv2", "tris.has_ns", "tris.has_uv",
    "tris.swaps_hand", "tris.material", "tris.area_light",
    "tris.shading_packed",
    "spheres.obj_to_world", "spheres.world_to_obj", "spheres.radius",
    "spheres.swaps_hand", "spheres.material",
    "materials.mtype", "materials.c0", "materials.c1", "materials.s0",
    "materials.remap", "materials.tex0", "materials.tex1",
    "materials.packed",
    "lights.ltype", "lights.p", "lights.i", "lights.m", "lights.area",
    "lights.cos_w", "lights.cos_f",
    "textures.texels", "textures.offset", "textures.width",
    "textures.height", "textures.texels_u8", "textures.pal_idx",
    "textures.palette",
    "background", "world_lo", "world_hi",
]

META_FIELDS = [f.name for f in dataclasses.fields(tdata.SceneMeta)]


def _port_leaves(scene) -> dict:
    d = scene.data
    out = {}
    for group in tp.SCENE_GROUPS:
        obj = getattr(d, group)
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f"{group}.{f.name}"] = None if v is None else v.cpu().numpy()
    for k in ("background", "world_lo", "world_hi"):
        out[k] = getattr(d, k).cpu().numpy()
    return out


@pytest.fixture(scope="module", params=SCENES)
def scene_pair(request):
    jscene, _ = tp.jax_scene(request.param)
    tscene, _ = tp.port_scene(request.param)
    return request.param, jscene, tscene


def _assert_same_bits(a, b, name):
    if a is None or b is None:
        assert a is None and b is None, f"{name}: one side missing"
        return
    assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), name


def test_tables_bit_identical(scene_pair):
    _, jscene, tscene = scene_pair
    ref = tp.jax_leaves(jscene)
    got = _port_leaves(tscene)
    for name in TABLE_LEAVES:
        _assert_same_bits(ref[name], got[name], name)


def test_world_bounds_are_bvh_root(scene_pair):
    """The scene box is the BVH root's box (the min/max over triangle
    vertices) extended by the sphere AABBs, in both packages."""
    _, jscene, tscene = scene_pair
    tri = np.stack([np.asarray(jscene.data.tris.p0),
                    np.asarray(jscene.data.tris.p1),
                    np.asarray(jscene.data.tris.p2)], axis=1).reshape(-1, 3)
    root_lo = jscene.bvh_host.node_lo[0]
    root_hi = jscene.bvh_host.node_hi[0]
    np.testing.assert_array_equal(tri.min(axis=0), root_lo)
    np.testing.assert_array_equal(tri.max(axis=0), root_hi)
    np.testing.assert_array_equal(tscene.bvh_host.node_lo[0], root_lo)
    np.testing.assert_array_equal(tscene.bvh_host.node_hi[0], root_hi)
    np.testing.assert_array_equal(tscene.data.world_lo.numpy(),
                                  np.asarray(jscene.data.world_lo))
    np.testing.assert_array_equal(tscene.data.world_hi.numpy(),
                                  np.asarray(jscene.data.world_hi))


def test_meta_matches(scene_pair):
    _, jscene, tscene = scene_pair
    for f in META_FIELDS:
        assert getattr(tscene.meta, f) == getattr(jscene.meta, f), f


def test_bridge_equals_port_build(scene_pair):
    _, jscene, tscene = scene_pair
    bridged = tp.bridged(jscene)
    a, b = _port_leaves(bridged), _port_leaves(tscene)
    for name in TABLE_LEAVES:
        _assert_same_bits(a[name], b[name], name)
    for f in META_FIELDS:
        assert getattr(bridged.meta, f) == getattr(tscene.meta, f), f


def test_bridge_rejects_missing_leaves():
    from yuki_tpu_torch import bridge

    jscene, _ = tp.jax_scene("pointspot")
    leaves = tp.jax_leaves(jscene)
    del leaves["tris.shading_packed"]
    with pytest.raises(KeyError, match="shading_packed"):
        bridge.scene_from_numpy(leaves, dataclasses.asdict(jscene.meta),
                                device="cpu")


def test_treelet_sized_scene_raises():
    """Scenes past DENSE_TRI_THRESHOLD build as treelet scenes, scenes up
    to it as dense ones; a dense scene's queries run the dense sweeps,
    a combined closest + shadow query (skip_light) included: its skip
    sweep no longer raises, and skip -1 ignores every triangle that is not
    an area light."""
    from yuki_tpu_torch import transforms as tf
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops.trace import dense_trace_plain, pack_triangles
    from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD, SceneBuilder

    def soup(n):
        pts = np.random.default_rng(0).random((3 * n, 3)).astype(np.float32)
        b = SceneBuilder("big")
        b.add_mesh(tf.Transform.identity(), np.arange(3 * n), pts)
        return b.build(device="cpu")

    big = soup(DENSE_TRI_THRESHOLD + 1)
    assert big.meta.traversal == "treelet"
    assert big.data.treelets.n_treelets > 0 and big.data.chunks is not None
    small = soup(DENSE_TRI_THRESHOLD)
    assert small.meta.traversal == "dense" and small.data.treelets is None
    o = torch.tensor([[0.5, 0.5, -1.0]]).expand(4, 3).contiguous()
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    t_max = torch.full((4,), 9.0)
    hit = traverse.intersect(small.data, small.meta, o, d, t_max)
    tris = small.data.tris
    t, prim, _, _ = dense_trace_plain(
        pack_triangles(tris.p0, tris.p1, tris.p2), o, d, t_max)
    assert hit.hit.all() and torch.equal(hit.prim, prim)
    assert torch.equal(hit.t, t)
    occ = traverse.any_intersect(small.data, small.meta, o, d, t_max,
                                 torch.full((4,), -2, dtype=torch.int32))
    assert occ.all()
    for skip, hits in ((0, True), (-1, False)):
        got = traverse.intersect(
            small.data, small.meta, o, d, t_max,
            skip_light=torch.full((4,), skip, dtype=torch.int32))
        assert bool(got.hit.all()) == hits and bool(got.hit.any()) == hits


def test_tiling_asset_raises(tmp_path):
    """A real basecolor PNG would need the unported image decoder."""
    from yuki_tpu_torch.scene import cornell

    png = tmp_path / "tiling.png"
    png.write_bytes(b"\x89PNG")
    with pytest.raises(NotImplementedError, match="decode_image_file"):
        cornell._check_no_tiling_asset(str(png))
    cornell._check_no_tiling_asset(str(tmp_path / "absent.png"))
