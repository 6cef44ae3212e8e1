"""Reading a torch.profiler Chrome trace: device busy time, launches,
kernel time by name, and the device's idle gaps labelled by what the host
was doing.

Device activity is the trace's "kernel", "gpu_memcpy" and "gpu_memset"
events.  The program's ``pass_scope`` ranges also appear on the device
("gpu_user_annotation"), repeating their kernels' time, so they are left
out.  The window is the span of the harness's own frame ranges.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
FRAME_RANGE = "portbench.frame"
INSTRUMENT_RANGE = "portbench.instrument"
_SCAN = 500


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    frames: int
    launches: int
    kernels: list = field(default_factory=list)  # (name, seconds) each
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def kernel_seconds(self, match) -> float:
        return sum(s for n, s in self.kernels if match(n))


def own_kernel_matcher(names):
    """A predicate: whether a trace's kernel name is one of ``names``
    (whole words: "bounce_kernel" matches "void bounce_kernel<true>(...)"
    and not "xbounce_kernel")."""
    if not names:
        return lambda n: False
    pat = re.compile(r"\b(?:" + "|".join(sorted(map(re.escape, names))) + r")\b")
    return lambda n: pat.search(n) is not None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _clip(s, e, spans):
    """The parts of [s, e] inside the sorted disjoint ``spans``."""
    i = max(bisect.bisect_right([a for a, _ in spans], s) - 1, 0)
    out = []
    while i < len(spans) and spans[i][0] < e:
        a, b = spans[i]
        if b > s:
            out.append((max(a, s), min(b, e)))
        i += 1
    return out


def _corr(e):
    args = e.get("args") or {}
    return args.get("correlation", args.get("correlation id"))


def summarize(trace, top: int = 10) -> TraceSummary:
    """The frames' device activity: the window is the union of the
    harness's frame ranges; kernels launched inside its instrumentation
    ranges (its own counters) are left out by their correlation ids."""
    events = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
    xs = [e for e in events if e.get("ph") == "X"]
    frames = [e for e in xs if e.get("name") == FRAME_RANGE
              and e.get("cat") == "user_annotation"]
    if not frames:
        raise ValueError(f"the trace holds no {FRAME_RANGE!r} range")
    main_tid = frames[0].get("tid")
    spans = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in frames)
    window_us = sum(b - a for a, b in spans)
    inst = _merge((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in xs if e.get("name") == INSTRUMENT_RANGE
                  and e.get("cat") == "user_annotation")
    skip = set()
    for e in xs:
        if e.get("cat") == "cuda_runtime" and inst:
            t = float(e["ts"])
            if _clip(t, t + float(e.get("dur", 0.0)), inst):
                c = _corr(e)
                if c is not None:
                    skip.add(c)
    dev, kernels, by_name = [], 0, {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS or _corr(e) in skip:
            continue
        s0 = float(e["ts"])
        parts = _clip(s0, s0 + float(e.get("dur", 0.0)), spans)
        if not parts:
            continue
        dev.extend(parts)
        if e["cat"] == "kernel":
            kernels += 1
        name = e.get("name", "?")
        by_name[name] = by_name.get(name, 0.0) + sum(b - a for a, b in parts) * 1e-6
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e.get("name", "?"))
                  for e in xs if e.get("cat") in HOST_CATS
                  and e.get("tid") == main_tid
                  and e.get("name") not in (FRAME_RANGE, INSTRUMENT_RANGE))
    starts = [h[0] for h in host]
    gaps = {}
    for a, b in spans:
        prev = a
        for s, e in [iv for iv in busy if a <= iv[0] < b] + [[b, b]]:
            if s > prev:
                mid = 0.5 * (prev + s)
                label = "host: no traced call"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - _SCAN, -1), -1):
                    if host[j][1] >= mid:
                        label = host[j][2]
                        break
                g = gaps.setdefault(label, [0.0, 0])
                g[0] += (s - prev) * 1e-6
                g[1] += 1
            prev = max(prev, e)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    idle = sorted(gaps.items(), key=lambda kv: -kv[1][0])
    return TraceSummary(
        window_s=window_us * 1e-6, busy_s=busy_us * 1e-6, frames=len(frames),
        launches=kernels, kernels=list(by_name.items()),
        device_ops=[[n, sec] for n, sec in ops[:top]],
        idle_gaps=[[f"{n} ({c} gaps)", sec] for n, (sec, c) in idle[:top]])
