"""Scene bridge: numpy tables in, the port's ``Scene`` out.

``scene_from_numpy`` takes a scene's leaves as numpy arrays keyed by
their dotted field path (``"tris.p0"``, ``"materials.packed"``,
``"textures.texels_u8"``, ``"world_lo"``, ...) and its ``SceneMeta``
fields as a dict, and builds the port's ``Scene`` on ``device``.  These
tables are this renderer's weights: a caller holding a ``yuki_tpu`` scene
converts its leaves with ``np.asarray`` and passes them here, so both
packages trace the same bits.  This module imports no JAX; the caller
converts.

Treelet scenes also carry ``"treelets.*"`` and ``"chunks.*"`` (the
``TreeletArrays`` fields: the four tables as arrays, ``leaf_size``,
``n_supers``, ``n_treelets`` and ``ts_max`` as ints; ``rows`` is the
port's ``[T*K, 12]`` layout, i.e. the first 12 columns of yuki_tpu's
``tris_padded``), and any scene may carry ``"bvh.*"`` (the ``BvhHost``
fields, kept on the host as numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bvh import BvhHost
from .device import resolve_device
from .scene.data import (
    LightArrays,
    MaterialArrays,
    Scene,
    SceneData,
    SceneMeta,
    SphereArrays,
    TextureAtlas,
    TriangleArrays,
)
from .treelets import TreeletArrays

_GROUPS = {
    "tris": TriangleArrays,
    "spheres": SphereArrays,
    "materials": MaterialArrays,
    "lights": LightArrays,
    "textures": TextureAtlas,
}
_TOP = ("background", "world_lo", "world_hi")
_OPTIONAL = {"textures.texels_u8", "textures.pal_idx", "textures.palette"}
_TREELET_INTS = ("leaf_size", "n_supers", "n_treelets", "ts_max")


def leaf_names() -> list[str]:
    """Every dotted leaf name the port's dense SceneData holds (treelet
    and BVH leaves are optional and not listed)."""
    names = [
        f"{group}.{f.name}"
        for group, cls in _GROUPS.items()
        for f in dataclasses.fields(cls)
    ]
    return names + list(_TOP)


def scene_from_numpy(leaves: dict, meta: dict, device=None) -> Scene:
    """Build the port's Scene from numpy leaves and SceneMeta fields.
    Missing required leaves raise; meta keys the port does not know are
    ignored (the JAX SceneMeta has no extra fields today)."""
    dev = resolve_device(device)
    missing = [k for k in leaf_names() if k not in leaves and k not in _OPTIONAL]
    if missing:
        raise KeyError(f"scene leaves missing: {missing}")

    def tensor(name):
        arr = leaves.get(name)
        if arr is None:
            return None
        # A private, writable copy: the caller's arrays may be read-only.
        return torch.as_tensor(np.array(arr), device=dev)

    def treelet_group(group):
        if f"{group}.rows" not in leaves:
            return None
        fields = {}
        for f in dataclasses.fields(TreeletArrays):
            key = f"{group}.{f.name}"
            fields[f.name] = (int(leaves[key]) if f.name in _TREELET_INTS
                              else tensor(key))
        return TreeletArrays(**fields)

    groups = {
        group: cls(**{f.name: tensor(f"{group}.{f.name}")
                      for f in dataclasses.fields(cls)})
        for group, cls in _GROUPS.items()
    }
    data = SceneData(**groups, **{k: tensor(k) for k in _TOP},
                     treelets=treelet_group("treelets"),
                     chunks=treelet_group("chunks"))
    bvh_host = None
    if "bvh.node_lo" in leaves:
        bvh_host = BvhHost(**{
            f.name: (int(leaves[f"bvh.{f.name}"]) if f.name == "max_leaf"
                     else np.array(leaves[f"bvh.{f.name}"]))
            for f in dataclasses.fields(BvhHost)
        })
    known = {f.name for f in dataclasses.fields(SceneMeta)}
    fields = {k: v for k, v in meta.items() if k in known}
    for k in ("light_types", "material_types"):
        if k in fields:
            fields[k] = tuple(int(x) for x in fields[k])
    return Scene(data=data, meta=SceneMeta(**fields), bvh_host=bvh_host)
