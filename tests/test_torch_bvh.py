"""The port's BVH builder (yuki_tpu_torch.bvh over native/bvh_builder.cpp,
built with g++ at first use) against yuki_tpu.bvh.build_bvh: the same
tree, field for field, for each split method on the triangle soup and for
the SAH build of the colonnade."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_parity as tp
from yuki_tpu.bvh import build_bvh as jax_build_bvh
from yuki_tpu_torch import native
from yuki_tpu_torch.bvh import BvhHost, build_bvh

torch.set_num_threads(2)

FIELDS = [f.name for f in dataclasses.fields(BvhHost)]


def _assert_same_tree(ref, got):
    for name in FIELDS:
        a, b = getattr(ref, name), getattr(got, name)
        if name == "max_leaf":
            assert a == b
            continue
        assert a.dtype == b.dtype, name
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("split", ["sah", "middle", "equal_counts"])
@pytest.mark.parametrize("max_shapes", [1, 4])
def test_bvh_matches_jax_on_soup(split, max_shapes):
    tp.jax_native_bvh()
    tri = tp.soup_triangles()
    ref = jax_build_bvh(tri, split_method=split, max_shapes_in_node=max_shapes)
    got = build_bvh(tri, split_method=split, max_shapes_in_node=max_shapes)
    _assert_same_tree(ref, got)
    assert sorted(got.prim_order.tolist()) == list(range(tri.shape[0]))


def test_bvh_matches_jax_on_colonnade():
    """The colonnade's SAH tree, as SceneBuilder.build makes it (four
    shapes per leaf), against yuki_tpu's builder on the same triangles."""
    tp.jax_native_bvh()
    scene, _ = tp.port_scene("colonnade")
    tris = scene.data.tris
    tri = np.stack([tris.p0.numpy(), tris.p1.numpy(), tris.p2.numpy()], 1)
    ref = jax_build_bvh(tri, split_method="sah", max_shapes_in_node=4)
    _assert_same_tree(ref, scene.bvh_host)
    assert scene.meta.bvh_max_leaf == ref.max_leaf


def test_bad_split_raises():
    with pytest.raises(ValueError, match="split method"):
        build_bvh(tp.soup_triangles(), split_method="median")


def test_library_is_built_once():
    """The library is loaded once per process and cached by content in
    the build directory, not in the package."""
    lib = native.library()
    assert native.library() is lib
    built = list(native.BUILD_DIR.glob("libyuki_bvh_*.so"))
    assert built and all(p.parent == native.BUILD_DIR for p in built)
