"""The 95th percentile of every window frame's wall time, in ms."""

from ..stats import percentile


def read(r):
    ms = r["win"].frames_ms
    return percentile(ms, 95.0) if ms else None
