"""The treelet dispatch's wide re-runs a traced frame
(``traverse.counts()["wide_reruns"]``)."""


def read(r):
    win = r["win"]
    c = win.counts.get("wide_reruns")
    return c / win.traced_frames if c is not None and win.traced_frames else None
