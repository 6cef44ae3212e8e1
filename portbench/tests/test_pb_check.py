"""The check that decides ``correct``: the plain reference against itself,
the program against the reference at a tiny size, the bfloat16 control,
and a run with its timed path broken underneath coming out not correct."""

from __future__ import annotations

import functools

import pytest
import torch

from portbench import calibrate, harness
from portbench.reference import integrate, intersect
from portbench.reference.rmath import camera_matrices

from .pbtools import tiny_cell

CPU = torch.device("cpu")


def test_reference_agrees_with_itself():
    """The same samples in other chunkings and block sizes, bit for bit;
    the blocked brute-force query against one triangle at a time."""
    cell = tiny_cell("cornell.path-uniform16")
    sc, cam = cell.module.reference_scene(cell.cfg, CPU, torch.float32, None)
    c2w, r2c = camera_matrices(cam, 64, 48)
    sampler, integ = harness.reference_objects(cell.traffic, torch.float32)
    px = torch.arange(0, 64, 3).repeat(4)
    py = torch.arange(4).repeat_interleave(22) * 11
    a = integrate.render_samples(sc, c2w, r2c, sampler, integ, px, py, 2, 99)
    b = integrate.render_samples(sc, c2w, r2c, sampler, integ, px, py, 2, 99,
                                 chunk=7)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    o = torch.as_tensor(c2w[:3, 3]).expand(50, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn(50, 3,
                                                  generator=torch.Generator().manual_seed(1)), dim=1)
    t_max = torch.full((50,), 3e38)
    hit = intersect.closest(sc, o, d, t_max)
    best = torch.full((50,), float("inf"))
    prim = torch.full((50,), -1, dtype=torch.int64)
    for i in range(sc.n_tris):
        h, t, _, _ = intersect.watertight(o[:, None], d[:, None], t_max[:, None],
                                          sc.tri.p0[None, i:i + 1],
                                          sc.tri.p1[None, i:i + 1],
                                          sc.tri.p2[None, i:i + 1])
        t = torch.where(h[:, 0], t[:, 0], float("inf"))
        take = t < best
        best = torch.where(take, t, best)
        prim = torch.where(take, i, prim)
    tri = hit.sphere < 0
    assert torch.equal(hit.prim[tri], prim[tri])


def _records(cell, seed):
    scene, cam, fs = cell.module.program_scene(cell.cfg, CPU, None)
    sampler, integ = harness.program_objects(cell.traffic)
    w, h = cell.cfg["res"]
    px, py = harness.sample_pixels(seed, (w, h), 16,
                                   int(cell.traffic["check_pixels"]))
    rec = harness.Recorder(CPU, w, h, px, py)
    rec.install()
    try:
        _, records = harness.run_window(
            cell, scene, cam, fs, sampler, integ, rec, seed, 0.0, False, px,
            py, CPU, lambda s: None, min_frames=int(cell.traffic["check_frames"]))
    finally:
        rec.restore()
    return records, px, py


@pytest.mark.parametrize("name", ["cornell.path-uniform16",
                                  "cornell.whitted-strat1"])
def test_program_passes_and_control_fails(name, tmp_path):
    """At a tiny size the program's samples agree with the reference
    within the cell's limits, and the reference in bfloat16, put in the
    program's place, fails them."""
    cell = tiny_cell(name, check_pixels=96)
    records, px, py = _records(cell, 2 ** 31 + 5)
    ref = cell.module.reference_scene(cell.cfg, CPU, torch.float32, None)
    low = cell.module.reference_scene(cell.cfg, CPU, torch.bfloat16, None)
    limit = cell.limits["mismatch_share"]
    good = harness.check_frames_against(cell, records, px, py, CPU,
                                        torch.float32, ref)
    assert good.samples > 0 and good.clean_pixels > 0
    assert good.share() <= limit
    ctrl = harness.check_frames_against(
        cell, calibrate.control_records(cell, records, px, py, CPU, low), px,
        py, CPU, torch.float32, ref)
    assert ctrl.share() > 3 * limit


def _fault(kind):
    """A broken integrator output: (li, rc, sample index) -> (li, rc)."""
    def apply(li, rc, s):
        if kind == "unchanged":  # the step returns its state as it came
            return torch.zeros_like(li), torch.zeros_like(rc)
        if kind == "half":  # half the lanes left out, the mean of the rest
            n = li.shape[0] // 2
            li = li.clone()
            li[n:] = li[:n].mean(dim=0)
            return li, rc
        if kind == "altered":  # every answer altered where it is produced
            return li * 1.01, rc
        return li, rc
    return apply


@pytest.mark.parametrize("kind", ["sound", "unchanged", "half", "altered"])
@pytest.mark.parametrize("name", ["cornell.path-uniform16",
                                  "cornell.whitted-strat1"])
def test_broken_timed_path_is_not_correct(name, kind, monkeypatch, tmp_path):
    """A whole run (the harness's look for a card skipped) with the
    program's integrator broken underneath the harness's counters."""
    from yuki_tpu_torch import renderer
    from yuki_tpu_torch.integrators import LiResult
    from yuki_tpu_torch.ops import path_fused

    fault = _fault(kind)
    wave = path_fused.path_li_wave

    def broken_wave(tb, px, py, sample_index, seed, sampler=None):
        li, rc = wave(tb, px, py, sample_index, seed, sampler)
        return fault(li, rc, sample_index)

    def broken(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            res = fn(*args, **kw)
            li, rc = fault(res.li, res.ray_count, args[4].sample_index)
            return LiResult(li=li, ray_count=rc)
        return call

    monkeypatch.setattr(path_fused, "path_li_wave", broken_wave)
    monkeypatch.setattr(renderer, "path_li", broken(renderer.path_li))
    monkeypatch.setattr(renderer, "whitted_li", broken(renderer.whitted_li))
    cell = tiny_cell(name)
    res = harness.run_cell(cell, 2 ** 31 + 17, 0.0, False, "cpu",
                           log=lambda s: None, work_dir=str(tmp_path))
    assert res["correct"] is (kind == "sound"), res["compared"]


def test_atrium_reference_and_program_agree(tmp_path):
    """The 1,024-triangle atrium through the program's pbrt and PLY
    loaders against the reference built from the generator's arrays."""
    cell = tiny_cell("atrium.path-uniform1", res=(32, 16), wave_tiles=2,
                     check_pixels=48)
    res = harness.run_cell(cell, 11, 0.0, False, "cpu", log=lambda s: None,
                           work_dir=str(tmp_path))
    assert res["correct"], res["compared"]
    assert res["compared"]["mismatch_share"]["value"] <= 0.005


def test_recorder_binds_by_name_and_refuses_shared_pixels():
    """The recorder finds a call's lanes by argument name, however they
    are passed; a checked call that carries a sampled pixel in two lanes
    stops the run."""
    px, py = torch.tensor([1, 5]), torch.tensor([2, 3])
    rec = harness.Recorder(CPU, 8, 8, px.numpy(), py.numpy())

    def entry(tb, px, py, sample_index, seed, sampler=None):
        n = px.shape[0]
        return torch.ones(n, 3) * sample_index, torch.full((n,), 2)

    wrapped = rec._recorded(entry)
    rec.capture = True
    lx, ly = torch.tensor([5, 0, 1]), torch.tensor([3, 0, 2])
    wrapped(None, seed=9, sample_index=4, py=ly, px=lx)
    total, calls = rec.take_frame()
    assert int(total) == 6
    ok, li, rc, s, seed = calls[0]
    assert ok.tolist() == [True, True] and (s, seed) == (4, 9)
    assert li[:, 0].tolist() == [4.0, 4.0] and rc.tolist() == [2, 2]
    wrapped(None, torch.tensor([5, 5]), torch.tensor([3, 3]), 0, 9)
    with pytest.raises(RuntimeError, match="more than one lane"):
        rec.take_frame()
