"""The treelet dispatch's host reads a traced frame
(``traverse.counts()["host_syncs"]``)."""


def read(r):
    win = r["win"]
    c = win.counts.get("host_syncs")
    return c / win.traced_frames if c is not None and win.traced_frames else None
