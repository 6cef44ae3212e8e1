"""Multi-device rendering: port of ``yuki_tpu/parallel/__init__.py``, tile
and sample sharding over a mesh of torch devices.

The reference's parallelism is a CPU worker pool popping tiles from a
mutex'd deque (renderer/render_manager.rs:197-244); yuki_tpu shards the
wave, the batch of film tiles rendered per call, over a device mesh with
two axes:

  "tiles"    data parallelism over pixel tiles: each shard renders its
             slice of the wave's tile origins against its own copy of the
             scene (the reference's Arc<Scene> broadcast);
  "samples"  sample-generation parallelism: each shard renders the same
             tiles at its own sample generations, and the shards' pixel
             sums are added.

A ``Mesh`` here is a [tiles, samples] grid of ``torch.device`` entries;
entries may repeat a device.  The scene is copied once to each distinct
device.  Each shard renders as yuki_tpu's ``_render_tiles`` does
(:38-70): camera rays from the stateless sampler, then ``path_li`` or
``whitted_li`` (not the fused wave), so a pixel's value does not depend
on which shard renders it: under any tiles partition the tiles equal the
single-device ``path_li`` render's bit for bit.  Shards on different
devices run in one thread a device; shards on one device run in turn.
The samples axis is summed on the mesh's first device in shard order, as
a psum would add them, and the rays are summed over every shard.

Unlike yuki_tpu's Renderer, the port's renders on the scene's device:
sharding is asked for here, explicitly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from dataclasses import dataclass
from typing import Optional

import torch

from .. import integrators as intg
from ..device import resolve_device
from ..sampling import SampleCtx


@dataclass(frozen=True)
class Mesh:
    """A [tiles, samples] grid of devices."""

    devices: tuple  # rows of torch.device, one row a tiles shard

    @property
    def shape(self) -> dict:
        return {"tiles": len(self.devices), "samples": len(self.devices[0])}


def default_mesh(n_tiles_axis: Optional[int] = None, n_samples_axis: int = 1,
                 devices=None) -> Mesh:
    """A mesh over ``devices`` (None: every card ``torch.cuda.device_count``
    sees), tiles-major: entry (i, j) is device i * n_samples_axis + j."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(dv) for dv in devices]
    n = len(devices)
    if n_tiles_axis is None:
        n_tiles_axis = n // n_samples_axis
    if n_tiles_axis * n_samples_axis != n:
        raise ValueError(f"a {n_tiles_axis} x {n_samples_axis} mesh needs "
                         f"{n_tiles_axis * n_samples_axis} devices, got {n}")
    return Mesh(tuple(tuple(devices[i * n_samples_axis:(i + 1)
                                    * n_samples_axis])
                      for i in range(n_tiles_axis)))


def scene_to(scene, device):
    """A copy of ``scene`` whose tensors lie on ``device`` (the scene
    itself when it is there already)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: move(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    if scene.device == device:
        return scene
    return dataclasses.replace(scene, data=move(scene.data))


def _render_tiles(scene, camera, sampler, integrator, tile_dim: int,
                  origins, sample_index: int, seed: int):
    """[B] tiles at one sample generation -> (pixels [B,td,td,3], rays f32
    scalar tensor), the per-lane maths of renderer.make_wave_renderer's
    ``path_li`` route."""
    td = tile_dim
    dev = origins.device
    iy, ix = torch.meshgrid(torch.arange(td, dtype=torch.int32, device=dev),
                            torch.arange(td, dtype=torch.int32, device=dev),
                            indexing="ij")
    px = (origins[:, 0, None, None] + ix[None]).reshape(-1).contiguous()
    py = (origins[:, 1, None, None] + iy[None]).reshape(-1).contiguous()
    ctx = SampleCtx(px=px, py=py, sample_index=sample_index, seed=seed)
    u = sampler.get_2d(ctx, 0)
    p_film = torch.stack([px.to(torch.float32), py.to(torch.float32)],
                         dim=-1) + u
    o, d = camera.ray(p_film)
    o, d = o.contiguous(), d.contiguous()
    if isinstance(integrator, intg.PathParams):
        res = intg.path_li(scene, scene.meta, integrator, sampler, ctx, o, d,
                           dim=2)
    elif isinstance(integrator, intg.WhittedParams):
        res = intg.whitted_li(scene, scene.meta, integrator, sampler, ctx, o,
                              d, dim=2)
    else:
        raise ValueError(f"unsupported sharded integrator {integrator!r}")
    return (res.li.reshape(origins.shape[0], td, td, 3),
            res.ray_count.to(torch.float32).sum())


def make_sharded_wave_renderer(scene, camera, sampler, integrator,
                               tile_dim: int, mesh: Mesh,
                               samples_per_launch: int = 1):
    """The multi-device render step over ``mesh``.

    Returns fn(origins [B,2] int, sample_base int, seed int) ->
      (tile_pixels [B,td,td,3], the SUM over this call's
       samples_per_launch sample generations, and the rays traced, an f32
       scalar tensor), both on the mesh's first device.

    B must divide by the tiles axis and samples_per_launch by the samples
    axis: samples shard j renders generations sample_base + j * k ... + k
    - 1 (k = samples_per_launch / samples axis), added in order."""
    n_tiles = mesh.shape["tiles"]
    n_samples = mesh.shape["samples"]
    if samples_per_launch % n_samples:
        raise ValueError(f"samples_per_launch {samples_per_launch} does not "
                         f"divide by the samples axis {n_samples}")
    per_shard = samples_per_launch // n_samples
    first = mesh.devices[0][0]
    scenes = {}
    for row in mesh.devices:
        for dv in row:
            if dv not in scenes:
                scenes[dv] = scene_to(scene, dv)

    def shard(i, j, origins, sample_base, seed):
        dv = mesh.devices[i][j]
        acc = rays = None
        for k in range(per_shard):
            px, r = _render_tiles(scenes[dv], camera, sampler, integrator,
                                  tile_dim, origins.to(dv),
                                  sample_base + j * per_shard + k, seed)
            acc = px if acc is None else acc + px
            rays = r if rays is None else rays + r
        return acc, rays

    def call(origins, sample_base: int, seed: int):
        origins = torch.as_tensor(origins).to(torch.int32)
        b = origins.shape[0]
        if b % n_tiles:
            raise ValueError(f"{b} tiles do not divide by the tiles axis "
                             f"{n_tiles}")
        per = b // n_tiles
        jobs = {}  # device -> [(i, j)], each device's shards in order
        for i in range(n_tiles):
            for j in range(n_samples):
                jobs.setdefault(mesh.devices[i][j], []).append((i, j))
        results, errors = {}, []

        def run(dv):
            try:
                with (torch.cuda.device(dv) if dv.type == "cuda"
                      else contextlib.nullcontext()):
                    for i, j in jobs[dv]:
                        results[i, j] = shard(
                            i, j, origins[i * per:(i + 1) * per],
                            int(sample_base), int(seed))
            except BaseException as e:  # raised again in the caller
                errors.append(e)

        if len(jobs) == 1:
            run(next(iter(jobs)))
        else:
            threads = [threading.Thread(target=run, args=(dv,))
                       for dv in jobs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            raise errors[0]
        tiles, rays = [], None
        for i in range(n_tiles):
            acc = None
            for j in range(n_samples):
                px, r = results[i, j]
                px, r = px.to(first), r.to(first)
                acc = px if acc is None else acc + px
                rays = r if rays is None else rays + r
            tiles.append(acc)
        return torch.cat(tiles), rays

    return call
