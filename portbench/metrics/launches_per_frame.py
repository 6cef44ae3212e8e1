"""Device kernels a traced frame, the harness's own counters left out."""


def read(r):
    t = r["trace"]
    return t.launches / t.frames if t is not None and t.frames else None
