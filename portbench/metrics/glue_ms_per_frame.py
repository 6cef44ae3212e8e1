"""Device ms a traced frame of everything that is not one of the
program's own CUDA kernels (torch's kernels, copies and fills)."""

from ..trace import own_kernel_matcher


def read(r):
    t = r["trace"]
    if t is None or not t.frames:
        return None
    own = own_kernel_matcher(r["own_kernels"])
    return t.kernel_seconds(lambda n: not own(n)) * 1e3 / t.frames
