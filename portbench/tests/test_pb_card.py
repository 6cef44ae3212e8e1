"""One short run of each cell on the card (skips without one): the
command as the benchmark's users run it, its last line and its exit."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["compared"]
    assert list(line)[-1] == "compared"
