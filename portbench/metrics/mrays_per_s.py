"""Closest-hit rays of the whole window over its wall time, in millions a
second (shadow rays are traced, not counted)."""

from ..stats import rate


def read(r):
    win = r["win"]
    return rate(win.rays, win.window_s) if win.window_s > 0 else None
