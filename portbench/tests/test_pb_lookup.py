"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by a name in it."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "portbench.run"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_full_check_fits_its_budget():
    """2 + 14 runs a cell at run_seconds + 60 s, 180 s a cell to compile
    and 1200 s spare must fit 43200 s with 24 cells."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
            if group in ("end_to_end", "per_layer"):
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {"mrays_per_s", "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            mv = e2e[m["moves"]]
            assert cell in mv.get("workloads", CELLS), (m["name"], cell)
    assert len(BENCH["per_layer"]) == 6


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.cfg["res"] == [1920, 1080]
    for key in ("integrator", "max_depth", "sampler", "pixel_samples",
                "samples_per_launch", "check_frames", "check_pixels"):
        assert key in c.traffic
    assert set(c.limits) == {"mismatch_share"}
    assert 0.0 < c.limits["mismatch_share"] < 0.05
    assert callable(c.module.program_scene)
    assert callable(c.module.reference_scene)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = importlib.import_module(f"portbench.metrics.{metric}")
    assert callable(mod.read)


def test_own_kernel_names():
    names = harness.own_kernel_names()
    for k in ("raygen_trace_kernel", "bounce_kernel", "wave_kernel",
              "dense_closest_kernel", "dense_any_kernel", "shade_kernel"):
        assert k in names
