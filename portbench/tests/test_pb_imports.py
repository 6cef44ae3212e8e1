"""The import check: whole top-level names, the harness free of JAX and
the JAX package, the reference free of the program, and a run that
loads either after its window printing no result."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from portbench import harness, importcheck


def test_whole_top_level_names():
    mods = {"yuki_tpu_torch": None, "yuki_tpu_torch.ops": None, "numpy": None}
    assert importcheck.forbidden_loaded(mods) == []
    assert "yuki_tpu_torch" in importcheck.top_names(mods)
    mods["yuki_tpu.traverse"] = None
    mods["jaxlib.xla"] = None
    assert importcheck.forbidden_loaded(mods) == ["jaxlib", "yuki_tpu"]
    assert importcheck.forbidden_loaded({"jaxtyping": None}) == []


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        check=True)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_after(
        "import torch\n"
        "from portbench.reference import integrate, intersect, rmath, scene, "
        "shading\n"
        "from portbench.configs import cornell, atrium\n"
        "sc, cam = cornell.reference_scene({}, 'cpu', "
        "torch.float32, None)\n"
        "sc2, cam2 = atrium.reference_scene({'res': [64, 48], 'generator': "
        "dict(columns_x=3, columns_z=2, segments=8, rings=2, drape_res=[6, "
        "8])}, 'cpu', torch.float32, None)\n")
    assert "yuki_tpu_torch" not in tops
    assert not {"jax", "jaxlib", "flax", "yuki_tpu"} & tops


def test_harness_and_program_load_no_jax():
    tops = _loaded_after(
        "import portbench.run, portbench.harness, portbench.calibrate\n"
        "import yuki_tpu_torch.renderer, yuki_tpu_torch.scene.atrium\n"
        "import yuki_tpu_torch.scene.cornell\n")
    assert "yuki_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "yuki_tpu"} & tops


@pytest.mark.parametrize("where", ["nowhere", "check", "reader"])
def test_jax_loaded_after_the_window_gives_no_result(where, monkeypatch,
                                                     capsys, tmp_path):
    """A whole run (the look for a card skipped, on the CPU) in which a
    forbidden module is loaded during the check or by a metric reader
    exits 3 and prints no result line."""
    import torch

    from portbench import run

    from .pbtools import tiny_cell

    cell = tiny_cell("cornell.path-uniform16")

    def plant():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    ref_scene = cell.module.reference_scene
    reader = run.metric_reader

    def planting_scene(*a, **kw):
        if where == "check":
            plant()
        return ref_scene(*a, **kw)

    def planting_reader(name):
        if where == "reader":
            plant()
        return reader(name)

    monkeypatch.setattr(cell.module, "reference_scene", planting_scene)
    monkeypatch.setattr(run, "metric_reader", planting_reader)
    monkeypatch.setattr(run, "load_cell", lambda name, bench=None: cell)
    monkeypatch.setattr(run, "run_cell", lambda c, seed, s, tr, dev:
                        harness.run_cell(c, seed, s, tr, "cpu",
                                         log=lambda m: None,
                                         work_dir=str(tmp_path)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    for var in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
        monkeypatch.setenv(var, str(tmp_path / var))
    rc = run.main(["--workload", cell.name, "--seed", "2147483777",
                   "--seconds", "0", "--trace", "0"])
    out, err = capsys.readouterr()
    if where == "nowhere":
        assert rc == 0 and json.loads(out.splitlines()[-1])["correct"]
    else:
        assert rc == 3 and out == "" and "jax" in err
