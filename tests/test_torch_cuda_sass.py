"""Each kernel's barrier instructions in the built library's SASS against
the barriers its source has.

ptxas (sm_90a) once emitted one of a kernel's three ``__syncthreads_or``s
a second time inside a staging loop whose trip count differed between the
block's threads: an illegal instruction on some launch shapes and not on
others.  Counting each kernel function's ``BAR.SYNC`` (``__syncthreads``)
and ``BAR.RED`` (``__syncthreads_or``) instructions in ``cuobjdump -sass``
catches such a repeat on every build, where a launch catches it only on
the shape that hangs.

``BARRIERS`` holds, for each kernel function, the barriers its source
emits: one per ``__syncthreads``/``__syncthreads_or`` call site, times the
trips of a loop the source unrolls (``#pragma unroll``), helpers counted
where they are inlined (``block_frames``, ``block_union``, ``block_max``,
``stage_scene``, ``sort_tile``).  Marked
``cuda``: it needs nvcc to build the library and cuobjdump (the CUDA
toolkit's, or the copy under ``triton/backends/nvidia/bin/``) to read it;
it skips without a card.
This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_sass.py

Run as a script with a library's path, it prints that library's counts:

    python tests/test_torch_cuda_sass.py build/yuki_tpu_torch/libyuki_kernels_<hash>.so
"""

import importlib.util
import os
import re
import shutil
import subprocess
import sys

import pytest

pytestmark = pytest.mark.cuda

# kernel function: (BAR.SYNC, BAR.RED); "<true>"/"<false>": the bool
# template argument.
BARRIERS = {
    # path_fused.cu: raygen's three frame votes (an unrolled loop) and
    # two stage barriers; the bounce kernel's stage and sort_tile's two;
    # the wave kernel's block_union, its camera sweep's two stage
    # barriers, stage_scene, sort_tile's two and the end of a bounce.
    "raygen_trace_kernel": (2, 3),
    "bounce_kernel": (3, 0),
    "wave_kernel": (7, 0),
    # shade_fused.cu: none.
    "shade_kernel": (0, 0),
    "resolve_kernel": (0, 0),
    # trace_dense.cu: block_frames, the copy reuse, the stage; the
    # occlusion sweep's block_frames, its vote before each stage and the
    # stage.
    "dense_closest_kernel<false>": (3, 0),
    "dense_closest_kernel<true>": (3, 0),
    "dense_any_kernel": (2, 1),
    # trace_rows.cu: block_frames, the chunk vote, stage_framed's
    # block_max; the occlusion walk the same, its window's stage and
    # block_union, and the block_max of its exit group.
    "rows_closest_kernel<false>": (2, 1),
    "rows_closest_kernel<true>": (2, 1),
    "rows_any_kernel": (5, 1),
    # trace_stream.cu: the dead-row vote and stage_framed's block_max.
    "cross_words_kernel": (0, 0),
    "slot_closest_kernel<false>": (1, 1),
    "slot_closest_kernel<true>": (1, 1),
    "slot_any_kernel": (1, 1),
    # trace_cull.cu: the word stage.
    "cull_kernel": (1, 0),
    # trace_treelets.cu: block_frames, a super window's stage and its
    # block_union, a treelet window's the same, a mask box's vote at
    # each level; the occlusion walk's window stages and a visited
    # treelet's are the exit votes, with the two block_unions.
    "treelet_closest_kernel": (5, 2),
    "treelet_any_kernel": (3, 3),
    # The vote count: each window's stage and block_union, at both levels.
    "treelet_votes_kernel": (4, 0),
    # trace_pairs.cu: block_frames, a window's stage and its block_union,
    # a mask pair's vote; the occlusion walk's window stage is a vote, and
    # a visited treelet's block_max gives r*.
    "pairs_closest_kernel": (3, 1),
    "pairs_any_kernel": (3, 2),
    # sampling.cu: none.
    "strat_draws_kernel": (0, 0),
    # whitted_fused.cu: none.
    "whitted_shade_kernel": (0, 0),
    "whitted_resolve_kernel": (0, 0),
    # trace_walker.cu: none; a warp walks a bundle.
    "walker_closest_kernel<false>": (0, 0),
    "walker_closest_kernel<true>": (0, 0),
    "walker_any_kernel": (0, 0),
}


def cuobjdump():
    """The CUDA toolkit's cuobjdump, or triton's copy; None if neither."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cands = [os.path.join(home, "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        cands.append(os.path.join(os.path.dirname(spec.origin), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    return next((c for c in cands if os.path.exists(c)), None)


def kernel_key(mangled):
    """The BARRIERS key of a mangled kernel name, or None."""
    for name in sorted({k.split("<")[0] for k in BARRIERS}, key=len,
                       reverse=True):
        if f"{len(name)}{name}" in mangled:
            if f"{name}<true>" in BARRIERS:
                return name + ("<true>" if "ILb1E" in mangled else "<false>")
            return name
    return None


def sass_barriers(tool, so):
    """{kernel: (BAR.SYNC, BAR.RED)} of every kernel function in the
    library's SASS, and the names of functions no key matches."""
    sass = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, unknown, cur = {}, [], None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = kernel_key(m.group(1))
            if cur is None:
                unknown.append(m.group(1))
            else:
                counts[cur] = (0, 0)
            continue
        if cur is None:
            continue
        sync, red = counts[cur]
        counts[cur] = (sync + len(re.findall(r"\bBAR\.SYNC\b", line)),
                       red + len(re.findall(r"\bBAR\.RED\b", line)))
    return counts, unknown


def test_each_kernels_barriers_match_its_source():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    from yuki_tpu_torch.native import BUILD_DIR
    from yuki_tpu_torch.ops import _build

    tool = cuobjdump()
    assert tool is not None, "no cuobjdump: neither the toolkit's nor triton's"
    _build.library()
    so = BUILD_DIR / f"libyuki_kernels_{_build._digest()}.so"
    counts, unknown = sass_barriers(tool, so)
    assert not unknown, f"kernel functions missing from BARRIERS: {unknown}"
    wrong = {k: (counts.get(k), want) for k, want in BARRIERS.items()
             if counts.get(k) != want}
    assert not wrong, ("(BAR.SYNC, BAR.RED) in the SASS against the "
                       f"source's: {wrong}; all counts {counts}")


if __name__ == "__main__":
    tool = cuobjdump()
    if tool is None or len(sys.argv) != 2:
        sys.exit("usage: test_torch_cuda_sass.py LIBRARY.so (needs cuobjdump)")
    found, missing = sass_barriers(tool, sys.argv[1])
    for key in sorted(found):
        print(f"{key}: BAR.SYNC {found[key][0]}, BAR.RED {found[key][1]}"
              f" (source table: {BARRIERS.get(key)})")
    print(f"unmatched functions: {missing}")
