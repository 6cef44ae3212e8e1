"""Share of a frame's wall time in which no operation ran on the device,
in %: the device's busy time a traced frame over the median wall time of
the window's frames, which run before the profiler is turned on.  The
profiler slows the host's side of a traced frame, not the device's, so
the traced frames' own wall time would count its cost as idle."""

import statistics


def read(r):
    t, ms = r["trace"], r["win"].frames_ms
    if t is None or not t.frames or not ms:
        return None
    return 100.0 * (1.0 - t.busy_s / t.frames / (statistics.median(ms) * 1e-3))
