"""Process start to the first timed frame, in seconds: imports, CUDA
start, the kernel library's load (or build), the scene, the warm frame."""


def read(r):
    return r["setup_s"]
