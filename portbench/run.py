"""Run one cell of the benchmark once and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures the PyTorch and CUDA port
(``yuki_tpu_torch``) on the card and nothing else: a run that finds no
card, or fewer cards than the cell asks for, exits with code 2 and prints
no result, and one that finds ``jax``, ``jaxlib``, ``flax`` or
``yuki_tpu`` among its loaded modules exits with code 3.

The last line of standard output is one JSON object: ``correct``,
``attempted`` (the window's frames), ``failed``, ``metrics`` (with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
last ``compared``: each number the check compared, beside its limit.
The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import importcheck
from .harness import ROOT, load_benchmark, load_cell, metric_reader, run_cell


def _env() -> None:
    """Keep every cache of the run inside the checkout, at fixed paths."""
    cache = os.path.join(ROOT, "build", "portbench", "cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(bench: dict, cell: str, trace: bool, readings: dict) -> dict:
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not _applies(m, cell):
            continue
        value = metric_reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result_line(bench: dict, cell, res: dict, trace: bool,
                device_kind: str) -> dict:
    """The run's result object, ``compared`` last."""
    r = res["readings"]
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": res["peak"]}
    out = {"correct": bool(res["correct"]), "attempted": r["win"].n_frames,
           "failed": 0, "metrics": metrics_of(bench, cell.name, trace, r),
           "device": device}
    t = r["trace"]
    if trace:
        if t is None:
            raise RuntimeError("the traced run holds no trace")
        device["busy_s"] = t.busy_s
        device["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.device_ops,
                            "idle_gaps": t.idle_gaps}
    out["compared"] = res["compared"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    found = importcheck.forbidden_loaded()
    if found:
        print(f"portbench: FAIL: loaded at start: {', '.join(found)}",
              file=sys.stderr)
        return 3
    bench = load_benchmark()
    cell = load_cell(args.workload, bench)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: FAIL: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    out = result_line(bench, cell, res, bool(args.trace),
                      torch.cuda.get_device_name(0))
    # Once the window, the check and every metric reader have run.
    found = importcheck.forbidden_loaded()
    if found:
        print(f"portbench: FAIL: loaded by the end of the run: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in res["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
