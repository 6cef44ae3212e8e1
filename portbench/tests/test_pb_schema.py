"""The run's last line: its keys in order, metrics with value and unit,
the device, the traced run's breakdown; and no line at all without a
card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness, run

from .pbtools import tiny_cell

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace, tmp_path):
    cell = tiny_cell("cornell.path-uniform16")
    res = harness.run_cell(cell, 2 ** 31 + 99, 0.0, trace, "cpu",
                           log=lambda s: None, work_dir=str(tmp_path))
    line = run.result_line(BENCH, cell, res, trace, "cpu (test)")
    assert list(line) == (["correct", "attempted", "failed", "metrics",
                           "device"] + (["breakdown"] if trace else [])
                          + ["compared"])
    assert line["correct"] is True and line["failed"] == 0
    json.dumps(line)
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]
            if cell.name in m.get("workloads", [cell.name])}
    got = set(line["metrics"])
    if trace:  # no kernel of the program's on the CPU: its roofline is silent
        assert got == want - {"wave_roofline_pct"}
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert got == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["compared"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cornell.path-uniform16", "--seed", "2147483999", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 2, out.stderr[-2000:]
    assert out.stdout == ""
