"""The trace reader on a small hand-made Chrome trace."""

from __future__ import annotations

import pytest

from portbench import trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    return {"traceEvents": [
        _x("portbench.frame", "user_annotation", 0, 100),
        _x("portbench.frame", "user_annotation", 200, 100),
        _x("aten::add", "cpu_op", 10, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 2, corr=1),
        _x("portbench.instrument", "user_annotation", 50, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 51, 2, corr=2),
        _x("aten::item", "cpu_op", 60, 40),
        _x("void bounce_kernel<true>(float*)", "kernel", 20, 20, tid=7,
           corr=1),
        _x("void index_add_kernel(int*)", "kernel", 55, 5, tid=7, corr=2),
        _x("elementwise_kernel", "kernel", 210, 40, tid=7, corr=3),
        _x("Memcpy DtoH", "gpu_memcpy", 250, 10, tid=7, corr=4),
        _x("trace.closest", "gpu_user_annotation", 0, 300, tid=7),
        _x("outside", "kernel", 120, 50, tid=7, corr=5),
    ]}


def test_summary():
    s = trace.summarize(_trace())
    assert s.frames == 2
    assert s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(70e-6)  # 20 + 40 + 10: instrument out
    assert s.launches == 2
    names = dict(s.kernels)
    assert "void index_add_kernel(int*)" not in names and "outside" not in names
    own = trace.own_kernel_matcher({"bounce_kernel"})
    assert own("void bounce_kernel<true>(float*)") and not own("xbounce_kernel")
    assert s.kernel_seconds(own) == pytest.approx(20e-6)
    gaps = dict(s.idle_gaps)
    # Frame 1: idle 0-20 (aten::add), 40-100 (aten::item covers 70);
    # frame 2: 200-210 and 260-300, no traced call.
    assert gaps["aten::add (1 gaps)"] == pytest.approx(20e-6)
    assert gaps["aten::item (1 gaps)"] == pytest.approx(60e-6)
    assert gaps["host: no traced call (2 gaps)"] == pytest.approx(50e-6)
    assert s.device_ops[0][0] == "elementwise_kernel"


def test_no_frames_is_an_error():
    with pytest.raises(ValueError):
        trace.summarize({"traceEvents": []})
