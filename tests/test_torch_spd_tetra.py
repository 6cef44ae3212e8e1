"""The SPD tetra configuration of the benchmark (``portbench/configs/
spd_tetra.py``): its generator (Haines's Standard Procedural Databases
``tetra``), the pbrt-v3 scene file and PLY meshes it writes as the
program's scene-file loader reads them, and a depth-6 frame (a treelet
scene) rendered through ``render_frame``, ``path_li`` and the treelet
dispatch against the benchmark's plain reference, sample by sample.
No JAX."""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.configs import spd_tetra
from yuki_tpu_torch import traverse
from yuki_tpu_torch.app.settings import SceneLoadSettings
from yuki_tpu_torch.scene.data import DENSE_TRI_THRESHOLD
from yuki_tpu_torch.scene.pbrt import load_pbrt

CELL = "spd_tetra.path-strat4"


def _cfg(depth, res=(32, 32)):
    return dict(harness.load_cell(CELL).cfg, depth=depth, res=list(res))


@pytest.mark.parametrize("depth", range(5))
def test_generator_counts_edges_area_winding(depth):
    """4^L leaves of 4 triangles; every leaf edge 2^(1-L); the total area
    4 sqrt(3) at every depth (subdivision keeps it); outward winding."""
    tets = spd_tetra.leaves(depth)
    assert tets.shape == (4 ** depth, 4, 3)
    edges = [np.linalg.norm(tets[:, i] - tets[:, j], axis=1)
             for i in range(4) for j in range(i + 1, 4)]
    np.testing.assert_allclose(np.stack(edges), 2.0 ** (1 - depth),
                               rtol=1e-12)
    tris64 = tets[:, spd_tetra.FACES].reshape(-1, 3, 3)
    n = np.cross(tris64[:, 1] - tris64[:, 0], tris64[:, 2] - tris64[:, 0])
    area = 0.5 * np.linalg.norm(n, axis=1).sum()
    assert area == pytest.approx(4.0 * math.sqrt(3.0), rel=1e-12)

    pts, tris = spd_tetra.generate(depth)["tetra"]
    assert pts.dtype == np.float32 and tris.shape == (4 ** depth * 4, 3)
    assert pts.shape == (4 ** depth * 4, 3)
    assert np.array_equal(pts, tets.reshape(-1, 3).astype(np.float32))
    tri = pts[tris].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    centre = np.repeat(pts.reshape(-1, 4, 3).mean(axis=1), 4, axis=0)
    assert (np.einsum("ij,ij->i", n, tri.mean(axis=1) - centre) > 0).all()
    # The base stands on y = 0; the floor lies just below it, facing up.
    assert pts[:, 1].min() == 0.0
    fp, ft = spd_tetra.generate(depth)["floor"]
    fn = np.cross(fp[ft[:, 1]] - fp[ft[:, 0]], fp[ft[:, 2]] - fp[ft[:, 0]])
    assert (fn[:, 1] > 0).all() and (fp[:, 1] == np.float32(-0.001)).all()


def test_files_load_bit_for_bit(tmp_path):
    """The written scene file and PLYs, loaded by ``load_pbrt``, give the
    generator's triangles bit for bit in file order, and the stated
    camera, film, lights and materials; unchanged files are not
    rewritten; the reference's tables are the program's."""
    cfg = _cfg(3, res=(64, 48))
    arrays = spd_tetra.write_files(cfg, str(tmp_path))
    path = spd_tetra.scene_path(str(tmp_path))
    before = {p: os.stat(p).st_mtime_ns for p in
              (path, tmp_path / "plys" / "tetra.ply")}
    spd_tetra.write_files(cfg, str(tmp_path))
    assert {p: os.stat(p).st_mtime_ns for p in before} == before

    scene, cam, film = load_pbrt(SceneLoadSettings(path=path), device="cpu")
    want = np.concatenate([arrays[k][0][arrays[k][1]] for k in
                           ("tetra", "floor")])
    d = scene.data.tris
    got = np.stack([d.p0.numpy(), d.p1.numpy(), d.p2.numpy()], axis=1)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert scene.meta.n_tris == 4 ** 3 * 4 + 2 and scene.meta.n_spheres == 0
    assert film.res == (64, 48)
    f32 = lambda v: tuple(np.float32(x) for x in v)
    assert f32(cam.position) == f32((2.6, 2.1, 3.4))
    assert f32(cam.target) == f32((0.0, 0.6, 0.0))
    assert f32(cam.up) == f32((0.0, 1.0, 0.0))
    assert cam.fov.axis == "y" and cam.fov.degrees == 40.0
    assert torch.equal(scene.data.background,
                       torch.tensor([0.35, 0.4, 0.5], dtype=torch.float32))
    assert len(scene.meta.light_types) == 1
    w = np.array([0.4, 1.0, 0.3], np.float32)
    w = w / np.linalg.norm(w)
    # Per triangle its material's kd: the tetrahedron's, then the floor's.
    kd = scene.data.materials.c0[scene.data.tris.material.long()]
    assert torch.equal(kd[:-2], torch.full_like(kd[:-2], np.float32(0.7)))
    assert torch.equal(kd[-2:], torch.full_like(kd[-2:], np.float32(0.45)))

    sc, spec = spd_tetra.reference_scene(cfg, torch.device("cpu"),
                                         torch.float32, str(tmp_path))
    for a, b in ((d.p0, sc.tri.p0), (d.p1, sc.tri.p1), (d.p2, sc.tri.p2)):
        assert torch.equal(a, b)
    assert torch.equal(scene.data.background, sc.background)
    assert tuple(scene.meta.light_types) == sc.light_types
    for k, L in enumerate(sc.lights):
        assert torch.equal(scene.data.lights.i[k], L["i"])
        assert torch.equal(scene.data.lights.m[k], L["m"])
    assert np.array_equal(sc.lights[0]["p"].numpy(), w)
    assert tuple(np.float32(v) for v in cam.position) == tuple(
        np.float32(v) for v in spec.position)
    assert cam.fov.axis == spec.fov_axis
    assert np.float32(cam.fov.degrees) == np.float32(spec.fov_degrees)


@pytest.fixture(scope="module")
def depth6(tmp_path_factory):
    """The depth-6 tetra (16,386 triangles) at 32x32, one wave of 4 tiles,
    loaded through the cell's own ``program_scene``."""
    cell = harness.load_cell(CELL)
    cell = dataclasses.replace(cell, cfg=dict(_cfg(6), wave_tiles=4),
                               traffic=dict(cell.traffic, check_pixels=96))
    work = str(tmp_path_factory.mktemp("spd_tetra"))
    scene, cam, fs = cell.module.program_scene(cell.cfg, torch.device("cpu"),
                                               work)
    return cell, scene, cam, fs, work


@pytest.mark.parametrize("seed", [2 ** 31 + 23, 7])
def test_depth6_frame_matches_reference(depth6, seed):
    """A depth-6 frame through render_frame, path_li and the treelet
    dispatch (Path d5, StratifiedSampler(2, 2)) agrees with the plain
    reference per sample within the cell's limit, every query through
    the dispatch."""
    cell, scene, cam, fs, work = depth6
    assert scene.meta.n_tris > DENSE_TRI_THRESHOLD
    assert scene.meta.traversal == "treelet"
    dev = torch.device("cpu")
    sampler, integ = harness.program_objects(cell.traffic)
    w, h = fs.res
    td = fs.tile_dim
    px, py = harness.sample_pixels(seed, (w, h), td,
                                   int(cell.traffic["check_pixels"]))
    rec = harness.Recorder(dev, -(-w // td) * td, -(-h // td) * td, px, py)
    traverse.reset_counts()
    rec.install()
    try:
        win, records = harness.run_window(cell, scene, cam, fs, sampler, integ,
                                          rec, seed, 0.0, False, px, py, dev,
                                          lambda s: None)
    finally:
        rec.restore()
    c = traverse.counts()
    assert win.n_frames == 1 and win.rays > 0
    # Every query of the frame went through the dispatch: per path_li
    # call and bounce one closest query of the wave's lanes and one
    # occlusion query of a shadow ray a lane (one light).
    lanes = w * h * sampler.samples_per_pixel
    assert c["dispatch_lanes"] == 2 * lanes * integ.max_depth
    assert c["fallback_lanes"] == 0
    ref = cell.module.reference_scene(cell.cfg, dev, torch.float32, work)
    chk = harness.check_frames_against(cell, records, px, py, dev,
                                       torch.float32, ref)
    assert chk.samples == px.size * sampler.samples_per_pixel
    assert chk.share() <= cell.limits["mismatch_share"], (
        chk.bad_samples, chk.bad_pixels)
