#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++ (the kernels are built from
yuki_tpu_torch/ops/csrc, the BVH builder from yuki_tpu_torch/native, at
first use, into build/yuki_tpu_torch/) and the yuki_tpu_torch package
beside this file.  It imports no JAX.  Phases:

  1. the card (nvidia-smi name and power limit), CUDA version, kernel
     build time and each kernel's ptxas register/spill report, and the
     bounds' operations ceiling (SMs x 128 FP32 lanes x the largest SM
     clock);
  2. the dense wave's kernels against their plain PyTorch versions on one
     4096-tile wave of the 1080p Cornell film (1,048,576 rays, depth 5):
     raygen_trace (every state plane and the hash bit for bit), every
     bounce 0-4 (each from the kernels' state before it), and the whole
     wave; with each kernel's time beside the plain version's and the
     bound from the plain version's tally of the sweeps' tests (raygen's
     from its camera sweep's, raygen_ops);
  3. the Cornell golden: 64x48, depth 4, 8 spp, seed 42 through
     make_wave_renderer on the card against
     tests/goldens/cornell_64x48_path4_8spp_seed42.npz (rendered by the
     JAX reference) under the chaos-aware bounds;
  4. the dense main path: render_frame on Cornell at 1920x1080, depth 5,
     UniformSampler 16 spp, 16-pixel tiles, 4096-tile waves, seed 1,
     counting kernel launches; the image must be finite, non-black and
     have the red wall left and the green wall right;
  4a. the dense trace kernels against their plain versions on Cornell's
     1,048,576-ray camera wave (closest) and its bounce-0 shadow rays
     (occlusion), and on a 4096-triangle soup with 65,536 rays, t_max 0
     lanes and skip ids; with the bounds from the plain versions'
     tallies (dense_ops for the closest sweep, any_ops for the occlusion
     sweep);
  4b. the dense path_li main path: the same Cornell film at 1 spp with
     the fused wave off (PATH_FUSED_MODE "off"), through camera rays,
     path_li and the dense trace kernels, at depth 5 and depth 2, each
     held against the fused wave's frame (depth 2: rtol 2e-6; depth 5:
     the chaos-aware bounds and ray counts within 1%); then the Cornell
     golden through the path_li route;
  4c. the stratified variants of raygen_trace (every plane bit for bit)
     and bounce (every bounce 0-4, each timed) against their plain
     versions on the Cornell wave with StratifiedSampler(4, 4)'s planes;
  4d. the one-kernel wave: wave_kernel against the two-kernel CUDA wave,
     bit for bit, on the Cornell wave with UniformSampler(16) and
     StratifiedSampler(4, 4), and against its plain version; the 1080p d5
     16 spp Cornell frame by both forms and both samplers (the one-kernel
     uniform frame is that kernel's main path: launches counted), equal
     bit for bit; the Cornell golden through wave_kernel;
  4e. StratifiedSampler(2, 2) on the 1080p Cornell film (4 spp) through
     the wave and through path_li, at depth 2 (rtol 2e-6) and depth 5
     (the chaos-aware bounds);
  4f. the stratified sampler's draws kernel (strat_draws_kernel) against
     the torch route on the card, bit for bit, for the Cornell wave's
     StratifiedSampler(4, 4) planes (27 planes over 1,048,576 lanes),
     timed beside the torch route, with its bound from strat_draw_ops'
     tally (each pipe's operations at its rate: 64 lanes an SM a clock
     on the INT32 ALU, 64 IMAD or 128 FP32 on the FMA pipes, 128 issued)
     and the planes' bytes; then one 16 spp stratified 1080p frame, counting its
     launches, its plain draws and the sampler's host reads (both 0);
  5. the colonnade's host build (124,478 triangles): BVH, treelets,
     chunks and slot budgets, each timed;
  6. the treelet path's kernels against their plain versions on one
     2048-tile wave of the 1080p colonnade (524,288 camera rays, seed 1),
     with inputs packed by the main path's own code: treelet_closest on
     the camera rays, shade at every bounce 0-4 of the first wave on the
     lanes path_li hands it (a frame's first calls, recorded), under
     UniformSampler and StratifiedSampler(2, 2)'s planes, each bounce
     timed, with its bound from the bytes and shade_ops' tally of the
     shading operations; treelet_any on the bounce-0
     shadow rays, resolve, then treelet_closest on the bounce-1 rays and
     treelet_any on their shadow rays; the walks' plain versions run on
     stated slices of whole 1024-ray blocks (on bounce 1, blocks holding
     live and parked lanes), and tally the work each ray's own query
     needs, from which the walks' bounds are computed; beside each slice,
     the contract's floor, the tests the block semantics force
     (``treelet_work``, a plain walk that must give the kernel's output),
     over the card's rate and counted at the SMs the slice's blocks fill;
  7. the divergent-wave kernels against their plain versions on the same
     wave's bounce-1 rays and their shadow rays (both lights): the cull on
     both, unsorted as path_li makes them and sorted by ray_sort_key (the
     sorted wave's lists permuted back must equal the unsorted's; each
     timed), the crossing words on the cull's overflow mini-wave and on a
     64-block slice, the closest and occlusion slot walks on the slots the
     dispatch lays out, and the closest walk, both instantiations (skip
     -2), on the bounce-1 wave's slots and on the overflow rays' wide
     re-run's (C_WIDE); with the bounds from the plain versions' tallies;
  8. the treelet dispatch against the treelet walk on the same rays: prim
     and occlusion equal apart from counted ties (|t| gaps of at most one
     ulp), t within one ulp and b0/b1 equal where prim is equal; then
     each query's time per call and its device breakdown;
  8a. the row-union kernels against their plain versions on the same
     wave's camera rays (with the probe's own words) and bounce-0 shadow
     rays (forced through the rows engine), with the bounds from the
     plain versions' tallies; then the dispatch on those coherent waves
     against the treelet walk under phase 8's rules;
  8b. the bundle walks against their plain versions on the same wave's
     bounce-1 rays (closest) and bounce-0 shadow rays (occlusion), with
     the walker's own lists and budget verdict, the share of list entries
     walked and the live rays a walked entry; then the dispatch with
     WALKER_CLOSEST / WALKER_ANY against the dispatch without them on the
     bounce-1 rays and their shadow rays (phase 8's rules), and each
     walker query's time per call and device breakdown;
  9. the colonnade golden: 64x48, depth 3, 1 spp, seed 1 against
     tests/goldens/torch_colonnade_64x48_path3_1spp_seed1.npz, with the
     divergent waves on the slot stream and on the bundle walker;
 10. the treelet main path: render_frame on the colonnade at 1920x1080,
     depth 5, UniformSampler 1 spp, 16-pixel tiles, 2048-tile waves, seed
     1 (bench.py:273-276), counting launches and the dispatch's branches
     (the treelet walk launches only on counted fallbacks), then the same
     frame under torch.profiler for where the device time goes and the
     device's idle share; once on the slot stream and once with both
     walker flags (the walker kernels' main path);
 11. the same colonnade frame with StratifiedSampler(2, 2), 4 spp,
     through path_li, timed;
 12. the combined wave on the colonnade: the wave's 524,288 bounce-1
     closest lanes (skip -2) and their 1,048,576 NEE shadow lanes (the
     rect light's id or -2, the 0.9999 chord), skip_sort=True, bary_count
     the closest lanes, on the slot stream, the bundle walker and the
     fallback, and its coherent form (camera and bounce-0 shadow lanes,
     sorted by ray_sort_key) on the rows engine: each engine driven once with the counts at 0 (the
     with_skip kernels' path), then skip -2 against no skip bit for bit,
     the shadow lanes' hit against any_intersect, the combined call's time
     against the two separate calls; the with_skip rows, slot and bundle
     walks against their plain versions bit for bit, each with its time
     beside the same kernel without skip (the closest slot walk without
     skip also against its plain version);
 12a. Cornell's combined wave (camera and bounce-0 shadow lanes, 2,097,152)
     through intersect and the dense skip sweep, against its plain
     version, dense_trace (skip -2) and any_trace (the shadow lanes);
 13. the block-pair walks on the bounce-1 rays and their shadow rays,
     sorted by ray_sort_key, at yuki_tpu's pair capacity: against their
     plain versions on 8 whole blocks, and on the whole wave against the
     treelet walk (t bit for bit, prim apart from counted ties, occlusion
     exact), with n_pairs, each call's time and the bounds;
 13a. the coherence sort: ray_sort_key on the card against the CPU's, the
     _sorted_call round trip, its cost per call at 524,288 and 1,572,864
     rays, and the dispatch sorted against skip_sort on the bounce-1 and
     shadow rays (equal apart from counted ties), timed;
 14. the loaders on the card: scenes/cornell.pbrt, scenes/example.xml and
     scenes/plane.ply loaded with device="cuda" and rendered through the
     threaded Renderer at their own film settings (PathParams(5),
     UniformSampler(1), seed 1; finite, non-black, the wave's kernels
     launched); the port's small atrium (generated by
     yuki_tpu_torch.scene.atrium) against
     tests/goldens/torch_atrium_small_64x48_path3_1spp_seed1.npz under the
     deep bounds; then the full atrium (347,136 triangles) generated and
     loaded through the pbrt and PLY loaders, with its generation, parse,
     BVH, treelet and chunk seconds, its 64x48, depth 3, 1 spp, seed 1
     render against tests/goldens/torch_atrium_64x48_path3_1spp_seed1.npz
     under the deep bounds, and its 1920x1080, depth 5, 1 spp,
     2048-tile-wave frame at seed 1 (bench.py:278-281): the median wall
     time of three, closest-hit rays, launches per kernel, the dispatch's
     branches, fallbacks and host reads, then one frame under
     torch.profiler for device busy time and the idle share;
 15. the headless entry point: ``python -m yuki_tpu_torch
     --scene=scenes/cornell.pbrt --settings=... --out=....exr
     --profile=...`` as a subprocess (Path depth 5, StratifiedSampler(2,
     2), Filmic, 640x480, 256-tile waves): exit 0, the EXR read back equal
     bit for bit to an in-process Renderer film of the same settings
     through filmic, and a trace naming path_fused.raygen_trace and
     path_fused.bounces; with the command's wall time; then the CLI again
     with no settings file (InitialSettings: Cornell, Whitted(3),
     StratifiedSampler(1, 1), 640x480, Filmic), its EXR equal bit for bit
     to the in-process render;
 16. the shading chain, Whitted and the debug views: Cornell's 64x48
     Whitted(3) 2 spp render against
     tests/goldens/cornell_64x48_whitted3_2spp_seed42.npz and the
     colonnade's 1 spp against
     tests/goldens/torch_colonnade_64x48_whitted3_1spp_seed1.npz (the deep
     bounds); the 1080p Whitted(3) 1 spp frames of Cornell (4096-tile
     waves) and the colonnade (2048-tile waves; its queries take the
     coherence sort), each the median wall time of three, with
     closest-hit rays, launches per kernel, tree steps and host reads;
     Whitted's shade and resolve kernels (whitted_fused.cu) on Cornell's
     1,048,576-lane wave (StratifiedSampler(1, 1)): step 0 against their
     plain twins bit for bit, each timed with CUDA events against its
     bytes bound, with its registers and spills, and the 1080p frame by
     the kernels against the chain (integrators._card_lanes forced off)
     bit for bit, both timed;
     the 1080p Cornell Path d5 1 spp frame through path_li with the fused
     wave off, by the shading chain (FUSED_SHADE_MODE "off") against the
     shade kernels (the deep bounds, rays within 1%), each timed; the four
     debug views at 1080p on Cornell and the colonnade, one frame each,
     with the BVH walk's steps and host reads; the card's 64x48
     BVHIntersections film of Cornell equal bit for bit to the CPU's;
 17. the web viewer: make_server(InitialSettings(), port=0) on the card
     in a temporary directory, a render with the page's defaults (Path
     d3, Stratified 4 spp, 640x480, Filmic) polled to done, /image.png
     decoded with zlib and equal to the tone-mapped film, debug rays at
     the film's centre for Path and Whitted, /bvh?level=3, /scene_stats,
     both EXR exports read back, /kill; then ``python -m yuki_tpu_torch
     --view --port 0`` as a subprocess answering /status; the render's
     launches (raygen_trace and bounce alone) and film (render_frame's
     bit for bit), each debug ray's (dense_closest alone);
 18. the bundle engine on the colonnade wave's bounce-1 rays and their
     shadow rays (sorted): the slot walks against their plain versions on
     4096 bundle-slot rows (bun 4 closest, bun 8 occlusion), then
     intersect with bun_closest 4 and 8 and any_intersect with bun_any 8
     against the slot stream on the divergent branch (prim apart from
     counted ties, t within an ulp, occlusion equal), each timed with its
     slot rows, overflow rays and wide re-runs;
 19. make_sharded_wave_renderer on a 4096-tile wave of the 1080p Cornell
     film (Path d5, 1 spp): a 4-entry tiles mesh and a 2 x 2 mesh, every
     entry cuda:0, bit for bit against the single-device path_li render
     (the samples axis against the summed generations), each render's
     launches path_li's kernels;
 20. the numpy BVH builder on the colonnade against the native one, field
     for field, with both build times.

Prints one JSON line describing the kernels, the card's name and power
limit, then as its last line {"ok": true, "device": {...}}.  Any failed
phase prints the reason to stderr and exits with status 1 without those
lines.
"""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.abspath(__file__))
WAVE_TILES = 4096
RES = (1920, 1080)
DEPTH = 5
SPP = 16
GOLDEN = os.path.join(REPO, "tests", "goldens",
                      "cornell_64x48_path4_8spp_seed42.npz")
COL_WAVE_TILES = 2048
COL_GOLDEN = os.path.join(REPO, "tests", "goldens",
                          "torch_colonnade_64x48_path3_1spp_seed1.npz")
ATRIUM_GOLDEN = os.path.join(REPO, "tests", "goldens",
                             "torch_atrium_small_64x48_path3_1spp_seed1.npz")
ATRIUM_FULL_GOLDEN = os.path.join(REPO, "tests", "goldens",
                                  "torch_atrium_64x48_path3_1spp_seed1.npz")
WHITTED_GOLDEN = os.path.join(REPO, "tests", "goldens",
                              "cornell_64x48_whitted3_2spp_seed42.npz")
COL_WHITTED_GOLDEN = os.path.join(
    REPO, "tests", "goldens", "torch_colonnade_64x48_whitted3_1spp_seed1.npz")
SLICE_BLOCKS = 64  # camera-wave 1024-ray blocks the plain walks run on
SOUP_TRIS = 4096  # the dense band's top (DENSE_TRI_THRESHOLD)
SOUP_RAYS = 65536
B1_BLOCKS = 8  # bounce-1 blocks the plain walks run on
CSRC = "yuki_tpu_torch/ops/csrc/"
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "raygen_trace": ("path_fused.cu", "yuki_tpu/ops/path_fused.py:517"),
    "bounce": ("path_fused.cu", "yuki_tpu/ops/path_fused.py:709"),
    "treelet_closest": ("trace_treelets.cu",
                        "yuki_tpu/ops/trace_treelets.py:55"),
    "treelet_any": ("trace_treelets.cu", "yuki_tpu/ops/trace_treelets.py:129"),
    # No TPU kernel: the order in which the closest walk launches the
    # blocks of its grid (the TPU runs them in turn, :235).
    "treelet_votes": ("trace_treelets.cu",
                      "yuki_tpu/ops/trace_treelets.py:235"),
    "shade": ("shade_fused.cu", "yuki_tpu/ops/shade_fused.py:798"),
    "resolve": ("shade_fused.cu", "yuki_tpu/ops/shade_fused.py:868"),
    "cull": ("trace_cull.cu", "yuki_tpu/ops/trace_cull.py:60"),
    "cross_words": ("trace_stream.cu", "yuki_tpu/ops/trace_stream.py:117"),
    "slot_closest": ("trace_stream.cu", "yuki_tpu/ops/trace_stream.py:812"),
    "slot_any": ("trace_stream.cu", "yuki_tpu/ops/trace_stream.py:850"),
    "rows_closest": ("trace_rows.cu", "yuki_tpu/ops/trace_rows.py:246"),
    "rows_any": ("trace_rows.cu", "yuki_tpu/ops/trace_rows.py:299"),
    "dense_closest": ("trace_dense.cu", "yuki_tpu/ops/trace.py:176"),
    "dense_any": ("trace_dense.cu", "yuki_tpu/ops/trace.py:221"),
    "walker_closest": ("trace_walker.cu", "yuki_tpu/ops/trace_walker.py:204"),
    "walker_any": ("trace_walker.cu", "yuki_tpu/ops/trace_walker.py:269"),
    "wave": ("path_fused.cu", "yuki_tpu/ops/path_fused.py:788"),
    "dense_closest_skip": ("trace_dense.cu", "yuki_tpu/ops/trace.py:249"),
    "rows_closest_skip": ("trace_rows.cu", "yuki_tpu/ops/trace_rows.py:246"),
    "slot_closest_skip": ("trace_stream.cu",
                          "yuki_tpu/ops/trace_stream.py:812"),
    "walker_closest_skip": ("trace_walker.cu",
                            "yuki_tpu/ops/trace_walker.py:204"),
    "pairs_closest": ("trace_pairs.cu", "yuki_tpu/ops/trace_pairs.py:176"),
    "pairs_any": ("trace_pairs.cu", "yuki_tpu/ops/trace_pairs.py:219"),
    # No TPU kernel: yuki_tpu draws a StratifiedSampler's values as XLA ops.
    "strat_draws": ("sampling.cu", "yuki_tpu/sampling.py:180"),
    # No TPU kernel: yuki_tpu runs Whitted's tree step as XLA ops.
    "whitted_shade": ("whitted_fused.cu",
                      "yuki_tpu/integrators/__init__.py:395"),
    "whitted_resolve": ("whitted_fused.cu",
                        "yuki_tpu/integrators/__init__.py:395"),
}
# The with_skip variants: no main-path frame launches them (no integrator
# of yuki_tpu makes combined closest + shadow waves); phase 12 drives them.
SKIP_KERNELS = ("dense_closest_skip", "rows_closest_skip",
                "slot_closest_skip", "walker_closest_skip")

# Bounds: the least time the card could take for a kernel's work, the
# larger of bytes over the memory rate (NVIDIA H100 SXM data sheet) and
# operations over the rate at which the card issues them.  Operations are
# adds, subtracts, multiplies, divides, square roots and min/max; compares
# and selects are not counted.  The data sheet's 67 TFLOP/s counts an FMA
# as two, but the kernels are built with -fmad=false, so each counted
# operation issues alone: the ceiling is SMs x 128 FP32 lanes x the
# largest SM clock, set by phase_device (about 33.5e12 a second on an
# H100 SXM).  Per unit of work:
PEAK_BYTES = 3.35e12  # B/s
PEAK_OPS = None  # operations a second, from phase_device
OPS_WATERTIGHT = 43  # 9 translate, 12 shear, 9 edges, 2 det, 6 t_scaled,
# 1 bound, 1 divide, 1 t, 2 barycentrics
OPS_SLAB = 24  # 6 subtract, 6 multiply, 12 min/max
OPS_SPHERE = 60  # transform 33, quadratic 21, root, q, two divides
OPS_CAMERA = 54  # jitter 2, raster->camera 19, normalise 9 (twice), c2w 15
# The raygen kernel's camera sweep: camera rays share their origin, so the
# translation of each triangle and each sphere's ro and c are work done
# once a wave, not once a ray (tests/test_torch_raygen_redesign.py counts
# these from a plain rendering of the sweep):
OPS_CAM_TEST = 30  # 12 shear, 9 edges, 2 det, 6 t_scaled, 1 bound
OPS_CAM_HIT = 4  # the winning test's reciprocal, t, b0 and b1
OPS_CAM_SPHERE = 38  # rd 15, a 5, b 6, discriminant 4, max and root 2,
# q 2, two divides, min and max
OPS_CAM_WAVE_TRI = 9  # a triangle's corners less the origin, once a wave
OPS_CAM_WAVE_SPHERE = 25  # a sphere's ro 18 and c 7, once a wave
# The dense closest sweep: a test up to its range test, the reciprocal of
# det and ti only on a pass, b0 and b1 only on a take
# (tests/test_torch_dense_redesign.py counts these on a plain rendering of
# the sweep; dense_ops sums them over the plain sweep's tally):
OPS_DENSE_TEST = 39  # 9 translate, 12 shear, 9 edges, 2 det, 6 t_scaled,
# 1 bound
OPS_DENSE_PASS = 2  # the reciprocal of det and ti
OPS_DENSE_TAKE = 2  # b0 and b1
# The dense occlusion sweep makes the same test and no divide, on each
# live lane's triangles up to its first occluder, its skip light's passed
# over (tests/test_torch_dense_any_redesign.py; any_ops).
OPS_SCALED = 40  # slot walks' scaled test: 9 translate, 12 shear, 9 edges,
# 2 det, 6 ts, 2 for the cross-multiplied compare (occlusion: 39, one bound)
CLOSEST_RAY_BYTES = 12 + 12 + 4 + 16  # o, d, t_max in; t, prim, b0, b1 out
ANY_RAY_BYTES = 12 + 12 + 4 + 4 + 1  # o, d, t_max, skip id in; occluded out
FLOATS = ("ox", "oy", "oz", "dx", "dy", "dz", "bx", "by", "bz",
          "rx", "ry", "rz")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps launches (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def deep_parity(np, ref, got, spp=1):
    """tests/test_path_fused.py:58-81 deep bounds on images or lane
    radiance [..., 3]: divergent pixels (error > 2e-4 + 2e-4|ref|) within
    1 - (11/12)^spp of them, mean within rtol 2e-3.  Returns (n_bad,
    limit, mean_rel)."""
    bad = (np.abs(got - ref) > 2e-4 + 2e-4 * np.abs(ref)).reshape(-1, 3)
    n = bad.shape[0]
    n_bad = int(bad.any(axis=-1).sum())
    limit = max(4, int(n * (1.0 - (11.0 / 12.0) ** spp)))
    mean_rel = abs(float(got.mean()) - float(ref.mean())) / abs(
        float(ref.mean()))
    check(n_bad <= limit, f"{n_bad} divergent of {n} (limit {limit})")
    check(mean_rel <= 2e-3, f"mean differs by {mean_rel:.3g} (limit 2e-3)")
    return n_bad, limit, mean_rel


def bound(nbytes, ops):
    """(bound_ms, bound_by) for a kernel moving nbytes and doing ops."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_usage(name):
    """The registers, spills and shared memory ptxas reported for the
    kernel function whose mangled name holds ``name`` (the library's
    build), as one string."""
    from yuki_tpu_torch.ops import _build

    cur, found = False, []
    for line in _build.ptxas_report.splitlines():
        if "Compiling entry function" in line:
            cur = name in line
        elif cur and ("Used" in line or "spill" in line):
            found.append(line.split(":", 1)[-1].strip())
    return "; ".join(found) or "not in the ptxas report"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def raygen_ops(n, n_tris, n_spheres, hits):
    """Operations the raygen function needs for n camera rays of which
    ``hits`` end on a triangle: each ray's camera, triangle and sphere
    tests, the winners' divides, and the translated triangles and the
    spheres' ro and c once."""
    return (n * (OPS_CAMERA + n_tris * OPS_CAM_TEST
                 + n_spheres * OPS_CAM_SPHERE) + hits * OPS_CAM_HIT
            + n_tris * OPS_CAM_WAVE_TRI + n_spheres * OPS_CAM_WAVE_SPHERE)


def dense_ops(stats):
    """Operations the dense closest sweep needs, from dense_trace_plain's
    tally: each live lane's test of every triangle, each passing test's
    divide and each taken hit's barycentrics."""
    return (stats["tests"] * OPS_DENSE_TEST + stats["passes"] * OPS_DENSE_PASS
            + stats["takes"] * OPS_DENSE_TAKE)


def any_ops(stats):
    """Operations the dense occlusion sweep needs, from any_trace_plain's
    tally: each live lane's tests up to its first occluder."""
    return stats["tests"] * OPS_DENSE_TEST


def shade_ops(torch, tsf, tb, rh, prim, ph, texp, dim0, bounce, spl=None):
    """Operations the shade kernel needs for these lanes, dead ones too:
    each lane shades its own branch (its material type, sigma or not, its
    sphere's surface or its triangle's).  Counted on one lane of each such
    group by the plain version with the group's statics alone (a
    TorchFunctionMode: FP32 adds, subtracts, multiplies, divides,
    reciprocals, square roots, min/max and clamps (one each) and the
    transcendentals, one for each element of each result), times the
    group's lanes.  The plain version makes a sphere lane's triangle
    surface too and both lobes of a glass lane, and a light's local frame
    once a light: those lanes are counted high."""
    import dataclasses

    from torch.overrides import TorchFunctionMode

    class Tally(TorchFunctionMode):
        OPS = {"add", "sub", "mul", "div", "__radd__", "__rsub__", "__rmul__",
               "__rdiv__", "__rtruediv__", "reciprocal", "sqrt", "minimum",
               "maximum", "clamp", "log", "sin", "cos"}

        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (getattr(func, "__name__", "") in self.OPS
                    and isinstance(out, torch.Tensor)
                    and out.is_floating_point()):
                self.n += out.numel()
            return out

    sph = rh[tsf._RH["sph"]]
    mid = tb.trs[prim.clamp(min=0).long(), 26]
    sid = torch.full_like(prim, -1, dtype=torch.int64)
    if tb.n_spheres:
        si = sph.clamp(0, tb.n_spheres - 1).long()
        on = (sph >= 0.0) & (sph < tb.n_spheres) & (si.float() == sph)
        mid = torch.where(on, tb.sp[si, 34], mid)
        sid = torch.where(on, si, -1)
    mrow = tb.mat[mid.clamp(min=0.0).long()]
    mtype = mrow[:, 0].long().clamp(0, 3)
    s0 = mrow[:, 7] if texp is None else texp[3]
    sigma = (s0 != 0.0).long() if tb.has_sigma else torch.zeros_like(mtype)
    key = (mtype * 2 + sigma) * (tb.n_spheres + 1) + sid + 1
    keys, counts = torch.unique(key, return_counts=True)
    total = 0
    for k, c in zip(keys.tolist(), counts.tolist()):
        j = int(torch.nonzero(key == k)[0])
        m_sig, s = divmod(k, tb.n_spheres + 1)
        m, sig = divmod(m_sig, 2)
        s -= 1
        one = dataclasses.replace(
            tb, present=frozenset({m}), has_sigma=bool(sig),
            n_spheres=1 if s >= 0 else 0,
            sp=tb.sp[s:s + 1] if s >= 0 else tb.sp[:1])
        r1 = rh[:, j:j + 1].clone()
        if s >= 0:
            r1[tsf._RH["sph"]] = 0.0
        with Tally() as tally:
            tsf.shade_planes_plain(
                one, r1, prim[j:j + 1], ph[j:j + 1],
                None if texp is None else texp[:, j:j + 1], dim0, bounce,
                None if spl is None else spl[:, j:j + 1])
        total += tally.n * c
    return total


class _Enough(Exception):
    """Raised by ``_capture``'s spies once every call it waits for is
    recorded: the frame stops there."""


def _capture(torch, frame, spies):
    """Run ``frame`` with the functions ``spies`` names, {(module, name):
    count}, wrapped: each records the arguments of its first ``count``
    calls (tensors cloned), and the frame stops once all are recorded.
    Returns {name: [args]}."""
    got = {name: [] for _, name in spies}
    saved = {key: getattr(*key) for key in spies}

    def spy(key, fn):
        def call(*args):
            if len(got[key[1]]) < spies[key]:
                got[key[1]].append(tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args))
                if all(len(got[k[1]]) >= c for k, c in spies.items()):
                    raise _Enough
            return fn(*args)
        return call

    for key, fn in saved.items():
        setattr(*key, spy(key, fn))
    try:
        frame()
    except _Enough:
        pass
    finally:
        for key, fn in saved.items():
            setattr(*key, fn)
    return got


def bounce_bound(tb, state_bytes, stats):
    """The bounce kernel's bound: the state planes in and out and the
    tables once; the sweeps' tests as bounce_plain tallies them (the next
    hit's full sweep of each traced lane, each light's shadow sweep up to
    its first hit); the shading arithmetic is not counted."""
    return bound(state_bytes + nbytes(tb.ms, tb.tri, tb.trs, tb.mat, tb.lt,
                                      tb.sp),
                 stats["tests"] * OPS_WATERTIGHT
                 + stats["sphere_tests"] * OPS_SPHERE)


def _kernel_modules():
    from yuki_tpu_torch.ops import (path_fused, shade_fused, trace, trace_cull,
                                    trace_pairs, trace_rows, trace_stream,
                                    trace_treelets, trace_walker,
                                    whitted_fused)

    return (path_fused, shade_fused, trace_treelets, trace_cull, trace_stream,
            trace_rows, trace, trace_walker, trace_pairs, whitted_fused)


def reset_all_launches():
    from yuki_tpu_torch import traverse

    for m in _kernel_modules():
        m.reset_launches()
    traverse.reset_counts()


def all_launches():
    out = {}
    for m in _kernel_modules():
        out.update(m.LAUNCHES)
    return out


def ops_ceiling(torch):
    """Set PEAK_OPS, the bounds' operations a second: SMs x 128 FP32
    lanes x the largest SM clock; returns (SMs, MHz)."""
    clk = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(clk.returncode == 0, f"nvidia-smi failed: {clk.stderr.strip()}")
    mhz = float(clk.stdout.strip().splitlines()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    global PEAK_OPS
    PEAK_OPS = n_sm * 128 * mhz * 1e6
    return n_sm, mhz


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    n_sm, mhz = ops_ceiling(torch)
    print(f"operations ceiling of the bounds: {n_sm} SMs x 128 lanes x "
          f"{mhz:.0f} MHz = {PEAK_OPS / 1e12:.3f}e12 a second")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    from yuki_tpu_torch.ops import _build

    from yuki_tpu_torch import native

    t0 = time.monotonic()
    _build.library()
    print(f"kernel build+load: {time.monotonic() - t0:.2f} s "
          f"({_build.BUILD_DIR})")
    for line in _build.ptxas_report.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line) \
                or "spill" in line:
            print(f"ptxas: {line.strip()}")
    t0 = time.monotonic()
    native.library()
    print(f"BVH builder build+load (g++): {time.monotonic() - t0:.2f} s")
    return card


def _cornell_wave(torch, dev):
    """The dense wave's tables for the 1080p Cornell film at depth DEPTH
    and the pixels of its first WAVE_TILES-tile wave: (tb, px, py)."""
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.film import FilmSettings, film_tiles
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    tb = tpf.make_tables(scene, Camera.create(cam, *RES), PathParams(DEPTH))
    tiles = film_tiles(FilmSettings(res=RES, tile_dim=16))[:WAVE_TILES]
    td = 16
    origins = torch.as_tensor([[t.x0, t.y0] for t in tiles],
                              dtype=torch.int32, device=dev)
    iy, ix = torch.meshgrid(torch.arange(td, device=dev, dtype=torch.int32),
                            torch.arange(td, device=dev, dtype=torch.int32),
                            indexing="ij")
    px = (origins[:, 0, None, None] + ix[None]).reshape(-1).contiguous()
    py = (origins[:, 1, None, None] + iy[None]).reshape(-1).contiguous()
    check(px.shape[0] == WAVE_TILES * td * td, f"wave has {px.shape[0]} rays")
    return tb, px, py


def phase_kernels(torch, np, dev):
    """Kernel vs plain version at main-path shapes."""
    from yuki_tpu_torch.ops import path_fused as tpf

    tb, px, py = _cornell_wave(torch, dev)
    n = px.shape[0]
    si, seed = 0, 1
    st = tpf._ST
    result = {}

    # raygen_trace
    st_k, ph_k = tpf.raygen_trace(px, py, si, seed, tb)
    st_p, ph_p = tpf.raygen_trace_plain(px, py, si, seed, tb)
    torch.cuda.synchronize()
    check(torch.equal(ph_k, ph_p), "raygen: sampler hash differs")
    err = 0.0
    for k in st:
        a, b = st_k[st[k]], st_p[st[k]]
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              f"raygen: {k} differs (max {float((a - b).abs().max()):.3g})")
    ms_k = cuda_ms(torch, lambda: tpf.raygen_trace(px, py, si, seed, tb), 10)
    ms_p = cuda_ms(torch, lambda: tpf.raygen_trace_plain(px, py, si, seed,
                                                         tb), 3)
    tables = nbytes(tb.ms, tb.tri, tb.sp)
    b_ms, b_by = bound(
        nbytes(px, py, st_k, ph_k) + tables,
        raygen_ops(n, tb.n_tris, tb.n_spheres,
                   int((st_p[st["prim"]] >= 0).sum())))
    print(f"raygen_trace [{n} rays]: kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err "
          f"{err:.3g}")
    result["raygen_trace"] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p,
                                  bound_ms=b_ms, bound_by=b_by)

    # every bounce, each kernel vs plain from one input state (the
    # kernels' chain)
    err = 0.0
    times = {}
    s_in = st_k
    for b in range(DEPTH):
        out_k = tpf.bounce(s_in, ph_k, b, tb)
        stats = {}
        out_p = tpf.bounce_plain(s_in, ph_k, b, tb, stats=stats)
        torch.cuda.synchronize()
        for k in ("alive", "spec", "rc"):
            check(torch.equal(out_k[st[k]], out_p[st[k]]),
                  f"bounce {b}: {k} differs")
        for k in FLOATS:
            a, c = out_k[st[k]], out_p[st[k]]
            check(torch.allclose(a, c, rtol=2e-6, atol=1e-7),
                  f"bounce {b}: {k} outside rtol 2e-6 / atol 1e-7 "
                  f"(max {float((a - c).abs().max()):.3g})")
            err = max(err, float((a - c).abs().max()))
        same = float((out_k[st["prim"]] == out_p[st["prim"]]).float().mean())
        check(same >= 0.999, f"bounce {b}: next-hit ids agree on {same:.5f}")
        t_k = cuda_ms(torch, lambda: tpf.bounce(s_in, ph_k, b, tb), 10)
        t_p = cuda_ms(torch, lambda: tpf.bounce_plain(s_in, ph_k, b, tb), 3)
        alive = int(s_in[st["alive"]].sum())
        b_ms, b_by = bounce_bound(tb, nbytes(s_in, ph_k, out_k), stats)
        print(f"bounce {b} [{n} rays, {alive} alive]: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{stats['tests']} triangle tests, {stats['sphere_tests']} "
              f"sphere tests), next-hit ids agree {same:.6f}")
        times[b] = (t_k, t_p, b_ms, b_by)
        s_in = out_k
    result["bounce"] = dict(max_abs_err=err, ms=times[0][0],
                            plain_ms=times[0][1], bound_ms=times[0][2],
                            bound_by=times[0][3])

    # whole wave, kernels vs plain
    li_k, rc_k = tpf.path_li_wave(tb, px, py, si, seed)
    s_p, ph_pl = tpf.raygen_trace_plain(px, py, si, seed, tb)
    for b in range(DEPTH):
        s_p = tpf.bounce_plain(s_p, ph_pl, b, tb)
    li_p = torch.stack([s_p[st[k]] for k in ("rx", "ry", "rz")], dim=-1)
    got, ref = li_k.cpu().numpy(), li_p.cpu().numpy()
    check(np.isfinite(got).all(), "wave: non-finite radiance")
    rays_k = int(rc_k.sum())
    rays_p = int(s_p[st["rc"]].sum())
    check(abs(rays_k - rays_p) <= max(16, 0.01 * rays_p),
          f"wave: ray counts {rays_k} vs {rays_p}")
    n_bad, limit, mean_rel = deep_parity(np, ref, got)
    print(f"wave [{n} rays, depth {DEPTH}]: kernels vs plain: rays "
          f"{rays_k} vs {rays_p}, divergent lanes {n_bad} (limit {limit}), "
          f"mean rel diff {mean_rel:.3g}")
    return result


def phase_golden(torch, np, dev, route="the fused wave"):
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    res = render_frame(scene, cam, FilmSettings(res=(64, 48), tile_dim=16),
                       UniformSampler(8), PathParams(4), wave_tiles=12,
                       samples_per_launch=8, seed=42)
    img = res.film.image()
    gold = np.load(GOLDEN)["img"]
    check(img.shape == gold.shape, f"golden: shape {img.shape}")
    check(np.isfinite(img).all(), "golden: non-finite pixels")
    n_bad, limit, mean_rel = deep_parity(np, gold, img, spp=8)
    rmse = float(np.sqrt(np.mean((img - gold) ** 2)))
    print(f"golden cornell 64x48 d4 8spp seed 42 through {route}: divergent "
          f"px {n_bad} (limit {limit}), mean rel diff {mean_rel:.3g}, rmse "
          f"{rmse:.4g}")


def phase_main_path(torch, np, dev, card):
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)
    torch.cuda.synchronize()
    reset_all_launches()
    res = render_frame(scene, cam, fs, UniformSampler(SPP),
                       PathParams(max_depth=DEPTH), wave_tiles=WAVE_TILES,
                       samples_per_launch=SPP, seed=1)
    torch.cuda.synchronize()
    counts = all_launches()
    launches = {k: counts[k] for k in ("raygen_trace", "bounce")}
    for name, count in counts.items():
        if name in launches:
            check(count > 0, f"main path: kernel {name} never launched")
        else:
            check(count == 0, f"main path: kernel {name} launched")
    img = res.film.image()
    check(img.shape == (RES[1], RES[0], 3), f"main path: shape {img.shape}")
    check(np.isfinite(img).all(), "main path: non-finite pixels")
    check(float(img.mean()) > 0.0, "main path: black image")
    h, w = img.shape[:2]
    band = img[int(h * 0.3):int(h * 0.7)]
    left = band[:, : w // 12].reshape(-1, 3).mean(axis=0)
    right = band[:, -(w // 12):].reshape(-1, 3).mean(axis=0)
    check(left[0] > left[1], f"main path: left wall not red {left}")
    check(right[1] > right[0], f"main path: right wall not green {right}")
    mrays = res.ray_count / res.elapsed_s / 1e6
    print(f"main path cornell {RES[0]}x{RES[1]} d{DEPTH} {SPP}spp "
          f"{WAVE_TILES}-tile waves: {res.ray_count} closest-hit rays in "
          f"{res.elapsed_s:.3f} s = {mrays:.2f} Mrays/s, "
          f"{SPP / res.elapsed_s:.3f} spp/s, launches {launches}, "
          f"image mean {float(img.mean()):.5f}, left {left.round(4)}, "
          f"right {right.round(4)} [{card}]")
    return launches


def _soup(torch, dev):
    """A 4096-triangle soup in [-3, 3]^3 with light ids -1, 0, 1, and
    SOUP_RAYS rays from seed 4: half at a triangle's centroid, the rest in
    random directions, every 16th axis-parallel from a corner; every
    seventh parked with t_max 0, a fifth with a chord of 2; skip ids -2,
    0, 1.  Returns (tris [T, 12], light, o, d, t_max, skip)."""
    g = torch.Generator().manual_seed(4)
    n, t = SOUP_RAYS, SOUP_TRIS
    base = (torch.rand((t, 1, 3), generator=g) - 0.5) * 6
    tri = base + torch.randn((t, 3, 3), generator=g) * 0.25
    packed = torch.cat([tri.reshape(t, 9), torch.zeros((t, 3))], dim=1)
    light = torch.randint(-1, 2, (t,), generator=g, dtype=torch.int32)
    o = (torch.rand((n, 3), generator=g) - 0.5) * 6
    d = torch.randn((n, 3), generator=g)
    i = torch.arange(n)
    aim = i % 2 == 1
    pick = torch.randint(0, t, (n,), generator=g)
    d[aim] = tri.mean(dim=1)[pick[aim]] - o[aim]
    par = i % 16 == 0
    d[par] = 0.0
    axis = torch.randint(0, 3, (n,), generator=g)[par]
    d[par.nonzero().squeeze(1), axis] = 1.0
    o[par] = tri[pick[par], 0]
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True)
    t_max = torch.full((n,), 3.4028234663852886e38)
    t_max[torch.rand((n,), generator=g) < 0.2] = 2.0
    t_max[i % 7 == 3] = 0.0
    skip = torch.randint(-2, 2, (n,), generator=g, dtype=torch.int32)
    skip[skip == -1] = -2
    return [x.contiguous().to(dev) for x in (packed, light, o, d, t_max,
                                             skip)]


def phase_dense_kernels(torch, np, dev, card):
    """The dense trace kernels against their plain versions: closest on
    Cornell's 1080p 4096-tile camera wave, occlusion on that wave's
    bounce-0 shadow rays (path_li's own shading), both on a 4096-triangle
    soup.  Bounds from the plain versions' tallies: closest, dense_ops
    (each lane with t_max > 0 tests every triangle, the divide only on a
    pass, b0 and b1 only on a take); occlusion, any_ops (the same test
    without a divide, up to the lane's first occluder, its skip light's
    triangles passed over); bytes: rays in, results out, the triangle
    rows once."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace as ttr
    from yuki_tpu_torch.ops.trace import F32_MAX, pack_triangles
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    data = scene.data
    ctx, o, d = _camera_wave(torch, dev, cam, WAVE_TILES)
    n = o.shape[0]
    t_max = torch.full((n,), F32_MAX, device=dev)
    tris = pack_triangles(data.tris.p0, data.tris.p1, data.tris.p2)
    hit = traverse.intersect(data, scene.meta, o, d, t_max, skip_sort=True)
    tables = tsf.make_shade_tables(scene, PathParams(DEPTH))
    ones = torch.ones_like(o)
    out = tsf.shade_fused(tables, hit, o, d, ones, hit.hit,
                          torch.zeros_like(hit.hit), _ph_i32(ctx), 2, 0)
    no, nd, nt, skip = out[5:9]
    light = data.tris.area_light
    soup = _soup(torch, dev)
    cases = (("Cornell camera wave", ("dense_closest",), tris, light, o, d,
              t_max, None),
             ("Cornell bounce-0 shadow rays", ("dense_any",), tris, light, no,
              nd, nt, skip),
             (f"{SOUP_TRIS}-triangle soup", ("dense_closest", "dense_any"),
              *soup))
    result = {}
    for what, names, tp, lt, ro, rd, rt, sk in cases:
        m, t = ro.shape[0], tp.shape[0]
        live = int((rt > 0.0).sum())
        for name in names:
            if name == "dense_closest":
                def kern():
                    return ttr.dense_trace(tp, ro, rd, rt)

                def plain(stats=None):
                    return ttr.dense_trace_plain(tp, ro, rd, rt, stats)
            else:
                def kern():
                    return ttr.any_trace(tp, lt, ro, rd, rt, sk)

                def plain(stats=None):
                    return ttr.any_trace_plain(tp, lt, ro, rd, rt, sk, stats)
            got = kern()
            stats = {}
            ref = plain(stats)
            torch.cuda.synchronize()
            if name == "dense_closest":
                for g, r, k in zip(got, ref, ("t", "prim", "b0", "b1")):
                    check(torch.equal(g, r), f"{name} on the {what}: {k} "
                          "differs")
                tests, nb = stats["tests"], m * (28 + 16) + t * 48
                ops = dense_ops(stats)
                found = (f"{int((got[1] >= 0).sum())} hits, "
                         f"{stats['passes']} tests passing to the divide")
            else:
                check(torch.equal(got, ref), f"{name} on the {what}: "
                      "occlusion differs")
                tests, nb = stats["tests"], m * (32 + 1) + t * 52
                ops = any_ops(stats)
                found = f"{int(got.sum())} occluded"
            ms_k = cuda_ms(torch, kern, 10)
            ms_p = cuda_ms(torch, plain, 1)
            b_ms, b_by = bound(nb, ops)
            print(f"{name} [{what}: {m} rays, {live} with t_max > 0, {t} "
                  f"triangles, {found}]: kernel {ms_k:.4f} ms, plain "
                  f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {tests} "
                  f"triangle tests): equal bit for bit [{card}]")
            result.setdefault(name, dict(max_abs_err=0.0, ms=ms_k,
                                         plain_ms=ms_p, bound_ms=b_ms,
                                         bound_by=b_by))
    return result


def phase_dense_path_li(torch, np, dev, card):
    """The dense path_li route at full width: the 1080p Cornell film at
    1 spp with the fused wave off, at depth 5 (the main path, launches
    counted) and depth 2, each against the fused wave's frame; then the
    Cornell golden through the same route."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace as ttr
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)

    def frame(depth):
        return render_frame(scene, cam, fs, UniformSampler(1),
                            PathParams(max_depth=depth),
                            wave_tiles=WAVE_TILES, seed=1)

    frames = {}
    tpf.PATH_FUSED_MODE = "off"
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        res = frame(DEPTH)
        torch.cuda.synchronize()
        counts = all_launches()
        launches = {k: counts[k] for k in ("dense_closest", "dense_any")}
        used = {*launches, *tsf.LAUNCHES}
        for name, count in counts.items():
            if name in used:
                check(count > 0, f"dense path_li: {name} never launched")
            else:
                check(count == 0, f"dense path_li: {name} launched")
        frames["path_li", DEPTH] = res
        frames["path_li", 2] = frame(2)
        phase_golden(torch, np, dev, "the path_li route")
    finally:
        tpf.PATH_FUSED_MODE = "auto"
    for depth in (DEPTH, 2):
        frames["wave", depth] = frame(depth)
    for depth in (DEPTH, 2):
        li, wave = frames["path_li", depth], frames["wave", depth]
        got, ref = li.film.image(), wave.film.image()
        check(np.isfinite(got).all() and float(got.mean()) > 0.0,
              f"dense path_li d{depth}: non-finite or black image")
        rays_l, rays_w = li.ray_count, wave.ray_count
        if depth <= 2:
            check(rays_l == rays_w, f"dense path_li d{depth}: rays {rays_l} "
                  f"vs the wave's {rays_w}")
            err = float(np.abs(got - ref).max())
            check(np.allclose(got, ref, rtol=2e-6, atol=1e-7),
                  f"dense path_li d{depth}: outside rtol 2e-6 of the wave "
                  f"(max abs {err:.3g})")
            how = f"max abs diff {err:.3g} (rtol 2e-6 held)"
        else:
            check(abs(rays_l - rays_w) <= max(16, 0.01 * rays_w),
                  f"dense path_li d{depth}: rays {rays_l} vs {rays_w}")
            n_bad, limit, mean_rel = deep_parity(np, ref, got)
            how = (f"divergent px {n_bad} (limit {limit}), mean rel diff "
                   f"{mean_rel:.3g}")
        print(f"dense path_li cornell {RES[0]}x{RES[1]} d{depth} 1spp "
              f"{WAVE_TILES}-tile waves: {rays_l} closest-hit rays in "
              f"{li.elapsed_s:.3f} s (the wave: {rays_w} in "
              f"{wave.elapsed_s:.3f} s); against the wave: {how}"
              + (f"; launches {launches}" if depth == DEPTH else "")
              + f" [{card}]")
    return launches


def sampler_name(sam):
    """UniformSampler(n) or StratifiedSampler(x, y)."""
    if hasattr(sam, "pixel_samples"):
        return f"UniformSampler({sam.pixel_samples})"
    return f"StratifiedSampler({sam.pixel_samples_x}, {sam.pixel_samples_y})"


def _check_wave_state(torch, st_k, st_p, what, exact, close, rtol, atol):
    """Kernel state planes against the plain version's: ``exact`` planes
    equal, ``close`` ones within rtol/atol.  Returns the largest gap."""
    from yuki_tpu_torch.ops import path_fused as tpf

    for k in exact:
        check(torch.equal(st_k[tpf._ST[k]], st_p[tpf._ST[k]]),
              f"{what}: {k} differs")
    err = 0.0
    for k in close:
        a, b = st_k[tpf._ST[k]], st_p[tpf._ST[k]]
        check(torch.allclose(a, b, rtol=rtol, atol=atol),
              f"{what}: {k} outside rtol {rtol:g} / atol {atol:g} (max "
              f"{float((a - b).abs().max()):.3g})")
        err = max(err, float((a - b).abs().max()))
    return err


def phase_strat_kernels(torch, np, dev, card):
    """The stratified variants of raygen_trace and bounce against their
    plain versions on the Cornell wave, with StratifiedSampler(4, 4)'s
    planes computed by the sampler (the rules of phase 2)."""
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.sampling import StratifiedSampler

    tb, px, py = _cornell_wave(torch, dev)
    n, si, seed = px.shape[0], 5, 1
    sam = StratifiedSampler(4, 4)
    spl = tpf.strat_planes(sam, px, py, si, seed, tb.n_lights, DEPTH)
    st_k, ph_k = tpf.raygen_trace(px, py, si, seed, tb, spl[:2])
    st_p, ph_p = tpf.raygen_trace_plain(px, py, si, seed, tb, spl[:2])
    st_u, _ = tpf.raygen_trace(px, py, si, seed, tb)
    torch.cuda.synchronize()
    check(torch.equal(ph_k, ph_p), "strat raygen: sampler hash differs")
    check(not torch.equal(st_k[tpf._ST["dx"]], st_u[tpf._ST["dx"]]),
          "strat raygen: the planes changed nothing")
    err = _check_wave_state(torch, st_k, st_p, "strat raygen",
                            tuple(tpf._ST), (), 0.0, 0.0)
    ms_k = cuda_ms(torch, lambda: tpf.raygen_trace(px, py, si, seed, tb,
                                                   spl[:2]), 10)
    ms_p = cuda_ms(torch, lambda: tpf.raygen_trace_plain(px, py, si, seed, tb,
                                                         spl[:2]), 3)
    # Bounds as phase 2's, with the planes read once more.
    b_ms, b_by = bound(
        nbytes(px, py, spl[:2], st_k, ph_k) + nbytes(tb.ms, tb.tri, tb.sp),
        raygen_ops(n, tb.n_tris, tb.n_spheres,
                   int((st_p[tpf._ST["prim"]] >= 0).sum())))
    print(f"raygen_trace strat [{n} rays, {sampler_name(sam)}]: kernel "
          f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"max_abs_err {err:.3g}; every plane and the hash equal "
          f"[{card}]")
    s_in = st_k
    for b in range(DEPTH):
        planes = tpf._bounce_planes(spl, tb, b)
        out_k = tpf.bounce(s_in, ph_k, b, tb, planes)
        stats = {}
        out_p = tpf.bounce_plain(s_in, ph_k, b, tb, planes, stats)
        torch.cuda.synchronize()
        err = _check_wave_state(torch, out_k, out_p, f"strat bounce {b}",
                                ("alive", "spec", "rc"), FLOATS, 2e-6, 1e-7)
        same = float((out_k[tpf._ST["prim"]]
                      == out_p[tpf._ST["prim"]]).float().mean())
        check(same >= 0.999, f"strat bounce {b}: next-hit ids agree on "
              f"{same:.5f}")
        ms_k = cuda_ms(torch, lambda: tpf.bounce(s_in, ph_k, b, tb, planes),
                       10)
        ms_p = cuda_ms(torch, lambda: tpf.bounce_plain(s_in, ph_k, b, tb,
                                                       planes), 3)
        b_ms, b_by = bounce_bound(tb, nbytes(s_in, ph_k, planes, out_k),
                                  stats)
        print(f"bounce {b} strat [{n} rays, "
              f"{int(s_in[tpf._ST['alive']].sum())} alive]: kernel "
              f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {stats['tests']} triangle tests, "
              f"{stats['sphere_tests']} sphere tests), max_abs_err {err:.3g}, "
              f"next-hit ids agree {same:.6f} [{card}]")
        s_in = out_k


def phase_wave1k(torch, np, dev, card):
    """The one-kernel wave: wave_kernel against the two-kernel CUDA wave,
    bit for bit, on the Cornell wave with UniformSampler(16) and
    StratifiedSampler(4, 4), and against its plain version; then the
    1080p d5 16 spp Cornell frame by both forms and both samplers (the
    one-kernel uniform frame is this kernel's main path: launches
    counted), and the Cornell golden through wave_kernel."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    tb, px, py = _cornell_wave(torch, dev)
    n, seed = px.shape[0], 1
    result = {}
    samplers = (UniformSampler(SPP), StratifiedSampler(4, 4))
    for sam in samplers:
        si = 3
        spl = tpf.strat_planes(sam, px, py, si, seed, tb.n_lights, DEPTH)

        def one():
            return tpf.wave(px, py, si, seed, tb, spl)

        def two():
            st, ph = tpf.raygen_trace(px, py, si, seed, tb,
                                      None if spl is None else spl[:2])
            for b in range(DEPTH):
                st = tpf.bounce(st, ph, b, tb, tpf._bounce_planes(spl, tb, b))
            return st[[tpf._ST[k] for k in ("rx", "ry", "rz", "rc")]]

        got, ref = one(), two()
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
              f"wave kernel vs the two-kernel wave ({sampler_name(sam)}): bits differ on "
              f"{int((got != ref).any(dim=0).sum())} lanes")
        ms_1 = cuda_ms(torch, one, 10)
        ms_2 = cuda_ms(torch, two, 10)
        rays = int(got[3].sum())
        line = (f"wave kernel [{n} rays, depth {DEPTH}, {sampler_name(sam)}]: {ms_1:.4f} ms "
                f"= {rays / ms_1 / 1e3:.2f} Mrays/s; two-kernel wave "
                f"{ms_2:.4f} ms = {rays / ms_2 / 1e3:.2f} Mrays/s; rgb and "
                f"ray count equal bit for bit ({rays} rays)")
        if isinstance(sam, UniformSampler):
            plain = tpf.wave_plain(px, py, si, seed, tb, spl)
            torch.cuda.synchronize()
            g, r = got[:3].t().cpu().numpy(), plain[:3].t().cpu().numpy()
            n_bad, limit, mean_rel = deep_parity(np, r, g)
            rays_p = int(plain[3].sum())
            check(abs(rays - rays_p) <= max(16, 0.01 * rays_p),
                  f"wave kernel vs plain: rays {rays} vs {rays_p}")
            ms_p = cuda_ms(torch, lambda: tpf.wave_plain(px, py, si, seed, tb,
                                                         spl), 1)
            # Bytes: pixels in, [4, N] out, the tables once; operations:
            # each closest-hit ray's full sweep (the shading and the
            # shadow sweeps, which exit early, are not counted).
            b_ms, b_by = bound(
                nbytes(px, py, got) + nbytes(tb.ms, tb.tri, tb.trs, tb.mat,
                                             tb.lt, tb.sp),
                rays * (tb.n_tris * OPS_WATERTIGHT
                        + tb.n_spheres * OPS_SPHERE))
            err = float(np.abs(g - r).max())
            result["wave"] = dict(max_abs_err=err, ms=ms_1, plain_ms=ms_p,
                                  bound_ms=b_ms, bound_by=b_by)
            line += (f"; plain {ms_p:.4f} ms (rays {rays_p}, divergent lanes "
                     f"{n_bad} of limit {limit}, mean rel diff {mean_rel:.3g})"
                     f", bound {b_ms:.4f} ms ({b_by}); ptxas "
                     f"{ptxas_usage('wave_kernel')}")
        print(line + f" [{card}]")

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)
    frames, launches = {}, {}
    for sam in samplers:
        for onek in (False, True):
            tpf.PATH_FUSED_ONEKERNEL = onek
            try:
                torch.cuda.synchronize()
                reset_all_launches()
                frames[onek] = render_frame(
                    scene, cam, fs, sam, PathParams(max_depth=DEPTH),
                    wave_tiles=WAVE_TILES, samples_per_launch=SPP, seed=1)
                torch.cuda.synchronize()
                counts = all_launches()
            finally:
                tpf.PATH_FUSED_ONEKERNEL = False
            used = ("wave",) if onek else ("raygen_trace", "bounce")
            for name, count in counts.items():
                check((count > 0) == (name in used),
                      f"cornell frame ({sampler_name(sam)}, one kernel {onek}): {name} "
                      f"launched {count} times")
            if onek and isinstance(sam, UniformSampler):
                launches["wave"] = counts["wave"]
            frame_launches = {**(frame_launches if onek else {}),
                              **{k: counts[k] for k in used}}
        a, b = frames[True], frames[False]
        img = a.film.image()
        check(np.isfinite(img).all() and float(img.mean()) > 0.0,
              f"one-kernel frame ({sampler_name(sam)}): non-finite or black")
        check(np.array_equal(img, b.film.image()) and
              a.ray_count == b.ray_count,
              f"one-kernel frame ({sampler_name(sam)}) differs from the two-kernel frame")
        print(f"cornell {RES[0]}x{RES[1]} d{DEPTH} {sam.samples_per_pixel}spp "
              f"{WAVE_TILES}-tile waves, {sampler_name(sam)}: launches "
              f"{frame_launches}; one kernel {a.ray_count} "
              f"rays in {a.elapsed_s:.4f} s = "
              f"{a.ray_count / a.elapsed_s / 1e6:.2f} Mrays/s; two kernels "
              f"{b.elapsed_s:.4f} s = {b.ray_count / b.elapsed_s / 1e6:.2f} "
              f"Mrays/s; images equal bit for bit, image mean "
              f"{float(img.mean()):.5f} [{card}]")
    tpf.PATH_FUSED_ONEKERNEL = True
    try:
        phase_golden(torch, np, dev, "the one-kernel wave")
    finally:
        tpf.PATH_FUSED_ONEKERNEL = False
    return result, launches


def phase_strat_frames(torch, np, dev, card):
    """StratifiedSampler(2, 2) on the 1080p Cornell film (4 spp) through
    the wave and through path_li (PATH_FUSED_MODE "off"), at depth 2
    (rtol 2e-6, equal ray counts) and DEPTH (the chaos-aware bounds)."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import StratifiedSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)
    sam = StratifiedSampler(2, 2)

    def frame(depth):
        return render_frame(scene, cam, fs, sam, PathParams(max_depth=depth),
                            wave_tiles=WAVE_TILES, samples_per_launch=4,
                            seed=1)

    for depth in (2, DEPTH):
        wave = frame(depth)
        tpf.PATH_FUSED_MODE = "off"
        try:
            li = frame(depth)
        finally:
            tpf.PATH_FUSED_MODE = "auto"
        got, ref = li.film.image(), wave.film.image()
        check(np.isfinite(got).all() and float(got.mean()) > 0.0,
              f"stratified path_li d{depth}: non-finite or black image")
        if depth <= 2:
            check(li.ray_count == wave.ray_count,
                  f"stratified d{depth}: rays {li.ray_count} vs the wave's "
                  f"{wave.ray_count}")
            err = float(np.abs(got - ref).max())
            check(np.allclose(got, ref, rtol=2e-6, atol=1e-7),
                  f"stratified d{depth}: path_li outside rtol 2e-6 of the "
                  f"wave (max abs {err:.3g})")
            how = f"max abs diff {err:.3g} (rtol 2e-6 held)"
        else:
            check(abs(li.ray_count - wave.ray_count)
                  <= max(16, 0.01 * wave.ray_count),
                  f"stratified d{depth}: rays {li.ray_count} vs "
                  f"{wave.ray_count}")
            n_bad, limit, mean_rel = deep_parity(np, ref, got, spp=4)
            how = (f"divergent px {n_bad} (limit {limit}), mean rel diff "
                   f"{mean_rel:.3g}")
        print(f"stratified cornell {RES[0]}x{RES[1]} d{depth} 4spp ({sampler_name(sam)}): "
              f"the wave {wave.ray_count} rays in {wave.elapsed_s:.4f} s, "
              f"path_li {li.ray_count} rays in {li.elapsed_s:.4f} s; "
              f"against the wave: {how} [{card}]")


def strat_draw_ops(draws, rounds):
    """Operations of the draws kernel a lane (sampling.cu) by the pipe that
    issues them on Hopper: (alu, mul, fp).  ``alu``: 32-bit integer adds,
    logic ops, shifts, compares, divides and modulos; ``mul``: 32-bit
    integer multiplies (IMAD, on the FMA pipe); ``fp``: conversions and
    float adds, multiplies and divides, each counted once.  A pcg hash is
    7 alu and 2 mul, its key's xor 1 alu.  The lane's pixel hash, jitter
    base and stratum key: 34 alu, 8 mul.  A draw's stratum key 8 alu and
    2 mul, a permutation round 25 alu and 7 mul and its loop test 1 alu,
    the round's multiplier 2 alu, the final add and modulo 2 alu; a
    jitter hash 9 alu, 2 mul, and 2 fp (its convert and scale); a 1-D
    value 3 fp more (convert, add, divide), a 2-D one 2 alu (modulo,
    divide) and 6 fp (two converts, adds and divides).  ``rounds``: the
    permutation rounds a draw runs (1 for a power-of-two stratum count,
    whose first round accepts)."""
    alu, mul, fp = 34, 8, 0
    for _, k in draws:
        alu += 8 + 26 * rounds + 4 + 9 * k + (2 if k == 2 else 0)
        mul += 2 + 7 * rounds + 2 * k
        fp += 2 * k + (6 if k == 2 else 3)
    return alu, mul, fp


def phase_strat_draws(torch, np, dev, card):
    """The draws kernel against the torch route on the card (the Cornell
    wave's planes), timed, with its bound; then a stratified frame's
    launches, plain draws and sampler host reads."""
    from yuki_tpu_torch import profiling
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.ops import strat_draws as tsd
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import SampleCtx, StratifiedSampler
    from yuki_tpu_torch.scene.cornell import cornell

    tb, px, py = _cornell_wave(torch, dev)
    n, si, seed = px.shape[0], 5, 2 ** 31 + 7
    sam = StratifiedSampler(4, 4)
    ctx = SampleCtx(px=px, py=py, sample_index=si, seed=seed)
    draws = [(0, 2)]
    for b in range(DEPTH):
        draws += tpf._bounce_draw_list(2 + b * tb.dims_per_bounce,
                                       tb.n_lights)
    tsd.reset_launches()
    got = tpf.strat_planes(sam, px, py, si, seed, tb.n_lights, DEPTH)
    ref = tsd.strat_draws_plain(sam, ctx, draws)
    torch.cuda.synchronize()
    check(tsd.LAUNCHES["strat_draws"] == 1,
          f"strat_draws: {tsd.LAUNCHES} launches for one wave call")
    check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
          "strat_draws: the kernel's planes differ from the torch route's")
    ms_k = cuda_ms(torch, lambda: tpf.strat_planes(
        sam, px, py, si, seed, tb.n_lights, DEPTH), 20)
    ms_p = cuda_ms(torch, lambda: tsd.strat_draws_plain(sam, ctx, draws), 3)
    alu, mul, fp = strat_draw_ops(draws, 1)
    ops = n * (alu + mul + fp)
    # Lanes an SM a clock: 64 on the INT32 ALU pipe, 64 IMAD or 128 FP32
    # on the FMA pipes, 128 issued in all (4 schedulers x 32).
    clocks = n * max(alu / 64, (mul + fp / 2) / 64, (alu + mul + fp) / 128)
    t_ops = clocks / (PEAK_OPS / 128) * 1e3
    t_bytes = nbytes(px, py, got) / PEAK_BYTES * 1e3
    b_ms, b_by = (t_ops, "operations") if t_ops >= t_bytes else (
        t_bytes, "bytes")
    print(f"strat_draws [{n} lanes, {got.shape[0]} planes, "
          f"{sampler_name(sam)}]: kernel {ms_k:.4f} ms, plain (the torch "
          f"route) {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {ops} "
          f"operations, {nbytes(px, py, got)} bytes); every plane equal; "
          f"{ptxas_usage('strat_draws_kernel')} [{card}]")
    result = {"strat_draws": dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                                  bound_ms=b_ms, bound_by=b_by)}

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)
    torch.cuda.synchronize()
    tsd.reset_launches()
    profiling.reset_counts()
    fr = render_frame(scene, cam, fs, sam, PathParams(max_depth=DEPTH),
                      wave_tiles=WAVE_TILES, samples_per_launch=SPP, seed=1)
    torch.cuda.synchronize()
    c = profiling.counts()
    launches = {"strat_draws": tsd.LAUNCHES["strat_draws"]}
    check(c.get("sampling.draws_plain", 0) == 0,
          f"strat frame: {c.get('sampling.draws_plain')} plain draws")
    check(c.get("host_reads.sampling", 0) == 0,
          f"strat frame: {c.get('host_reads.sampling')} sampler host reads")
    print(f"strat frame cornell {RES[0]}x{RES[1]} d{DEPTH} {SPP}spp "
          f"({sampler_name(sam)}): {fr.ray_count} rays in "
          f"{fr.elapsed_s:.4f} s, strat_draws launches "
          f"{launches['strat_draws']}, draws {c.get('sampling.draws_kernel')}"
          f", host reads {c} [{card}]")
    profiling.reset_counts()
    return result, launches


def phase_colonnade_build(torch, np, dev):
    """The colonnade's host build, with SceneBuilder.build's stage times."""
    from yuki_tpu_torch.scene.testscenes import colonnade

    t0 = time.monotonic()
    scene, cam, _ = colonnade(device=dev)
    t_scene = time.monotonic() - t0
    sec = scene.build_seconds
    tl, meta = scene.data.treelets, scene.meta
    check(meta.traversal == "treelet", f"colonnade: traversal {meta.traversal}")
    print(f"colonnade build: {t_scene:.3f} s in all (host): BVH "
          f"{sec['bvh']:.3f} s, treelets {sec['treelets']:.3f} s, chunks "
          f"{sec['chunks']:.3f} s, slot budgets {sec['slot_mult']:.3f} s; "
          f"n_tris {meta.n_tris}, n_treelets {tl.n_treelets}, n_supers "
          f"{tl.n_supers}, chunks {scene.data.chunks.n_treelets}, slot_mult "
          f"{meta.slot_mult_tight}/{meta.slot_mult}")
    return scene, cam


def _camera_wave(torch, dev, cam, n_tiles):
    """Camera rays of the first ``n_tiles``-tile wave of a 1080p film,
    sample 0, seed 1, as make_wave_renderer makes them."""
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.film import FilmSettings, film_tiles
    from yuki_tpu_torch.sampling import SampleCtx, UniformSampler

    tiles = film_tiles(FilmSettings(res=RES, tile_dim=16))[:n_tiles]
    origins = torch.as_tensor([[t.x0, t.y0] for t in tiles],
                              dtype=torch.int32, device=dev)
    iy, ix = torch.meshgrid(torch.arange(16, device=dev, dtype=torch.int32),
                            torch.arange(16, device=dev, dtype=torch.int32),
                            indexing="ij")
    px = (origins[:, 0, None, None] + ix[None]).reshape(-1)
    py = (origins[:, 1, None, None] + iy[None]).reshape(-1)
    ctx = SampleCtx(px=px, py=py, sample_index=0, seed=1)
    u = UniformSampler(1).get_2d(ctx, 0)
    o, d = Camera.create(cam, *RES).ray(
        torch.stack([px.float(), py.float()], dim=-1) + u)
    return ctx, o.contiguous(), d.contiguous()


def _compare_closest(torch, tl, got, o, d, t_max, a, m, what):
    """treelet_closest's output ``got`` against the plain walk on rays
    [a, a + m); returns the plain walk's tally of the work."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    stats = {}
    ref = ttt.treelet_closest_plain(tl, o[a:a + m], d[a:a + m],
                                    t_max[a:a + m], stats)
    torch.cuda.synchronize()
    for g, r, k in zip(got, ref, ("t", "prim", "b0", "b1")):
        check(torch.equal(g[a:a + m], r),
              f"treelet_closest on {what}: {k} differs")
    return stats


def _compare_any(torch, tl, occ, no, nd, nt, skip, n, n_lights, a, m, what):
    """treelet_any's output ``occ`` on light-major shadow rays against the
    plain walk on rays [a, a + m) of each light; returns the tally."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    stats = {}
    for li in range(n_lights):
        lo = li * n + a
        ref = ttt.treelet_any_plain(tl, no[lo:lo + m], nd[lo:lo + m],
                                    nt[lo:lo + m], skip[lo:lo + m], stats)
        check(torch.equal(occ[lo:lo + m], ref),
              f"treelet_any on {what}: light {li} occlusion differs")
    return stats


def treelet_work(torch, tl, rays, spans, out=None):
    """The treelet walk's work on each span [lo, hi) of ``rays``, (o, d,
    t_max) for the closest walk or (o, d, t_max, skip) for the occlusion
    walk, from a plain walk with the plain versions' decisions, which must
    give the kernel's output ``out`` (t, prim, b0, b1, or occluded, over
    all the rays; None: not checked).  Summed over the spans: "blocks",
    "supers" and "visited" (super and treelet visits of the blocks),
    "live" (lanes that can take or be blocked, t_max > 0 (occlusion: or
    NaN) and not yet occluded, summed over the visits), "real_rows"
    (summed over the visits), "forced" (the tests the block contract
    forces: each visit's live lanes against the treelet's real rows, the
    occlusion walk's up to each lane's first blocker), "took" (closest:
    visits after which some lane took a hit) and "per_block" (each block's
    treelet visits)."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    closest = len(rays) == 3
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    real = (rows[:, :, 10] >= 0.0).sum(dim=1).tolist()
    ranges = tl.super_range.tolist()
    acc = dict.fromkeys(("blocks", "supers", "visited", "live", "real_rows",
                         "forced", "took"), 0)
    acc["per_block"] = []
    for lo, hi in spans:
        planes, n = ttt._pack(*(x[lo:hi] for x in rays))
        tm = planes[6]
        walk = ttt._Rays(*planes[:6])
        live = tm > 0.0 if closest else ~(tm <= 0.0)
        t = tm.clone()
        hits = [torch.full_like(tm, -1, dtype=torch.int32),
                torch.zeros_like(tm), torch.zeros_like(tm)]
        occ = torch.zeros_like(live)
        per_block = torch.zeros(tm.shape[0], dtype=torch.int64,
                                device=tm.device)
        t_vote = t if closest else tm  # t falls in place
        for s in range(tl.n_supers):
            in_super = walk.slab(tl.super_bounds[s], t_vote).any(dim=1)
            if not closest:
                in_super &= (~occ).any(dim=1)
            acc["supers"] += int(in_super.sum())
            t0, tc = ranges[s]
            for tt in range(t0, t0 + tc) if bool(in_super.any()) else ():
                visit = in_super & walk.slab(tl.treelet_bounds[tt],
                                             t_vote).any(dim=1)
                if not closest:
                    visit &= (~occ).any(dim=1)
                vb = torch.nonzero(visit).squeeze(1)
                if vb.numel() == 0:
                    continue
                per_block[vb] += 1
                acc["visited"] += vb.numel()
                acc["real_rows"] += vb.numel() * real[tt]
                tri = rows[tt]
                terms = ttt._edge_terms(walk.lanes(vb), tri)
                if closest:
                    n_live = int(live[vb].sum())
                    acc["live"] += n_live
                    acc["forced"] += n_live * real[tt]
                    before = t[vb]
                    got = ttt._accept_in_order(
                        tri, terms, *(x[vb].reshape(-1) for x in (t, *hits)))
                    for x, g in zip((t, *hits), got):
                        x[vb] = g.reshape(vb.numel(), -1)
                    acc["took"] += int((t[vb] != before).any(dim=1).sum())
                    continue
                base_ok, det, t_scaled = terms[:3]
                blocked = (base_ok & ttt._in_range(det, t_scaled,
                                                   tm[vb].reshape(-1)[None])
                           & (tri[:, 9, None] != planes[7][vb].reshape(-1)
                              .to(torch.float32)[None])
                           & (tri[:, 10, None] >= 0.0))
                open_ = (live[vb] & ~occ[vb]).reshape(-1)
                first = torch.where(blocked.any(dim=0),
                                    blocked.int().argmax(dim=0) + 1, real[tt])
                acc["live"] += int(open_.sum())
                acc["forced"] += int((first * open_).sum())
                occ[vb] |= blocked.any(dim=0).reshape(vb.numel(), -1)
        acc["blocks"] += tm.shape[0]
        acc["per_block"] += per_block.tolist()
        if out is None:
            continue
        mine = (t, *hits) if closest else (occ,)
        want = out if closest else (out,)
        for x, w in zip(mine, want):
            x, w = x.reshape(-1)[:n], w[lo:hi]
            same = (torch.equal(x.view(torch.int32), w.view(torch.int32))
                    if x.dtype == torch.float32 else torch.equal(x, w))
            check(same, "treelet walk statistics: the plain walk differs "
                  "from the kernel")
    return acc


def treelet_floor(torch, work):
    """The contract's floor of a walk's ``work``: its forced tests at
    OPS_DENSE_TEST operations over the card's rate, in ms, and the same
    counted at the SMs its blocks can fill."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ms = work["forced"] * OPS_DENSE_TEST / PEAK_OPS * 1e3
    return ms, ms * n_sm / min(n_sm, work["blocks"])


def _floor_text(torch, work):
    ms, at_sms = treelet_floor(torch, work)
    return (f"contract's floor {ms:.4f} ms ({work['forced']} forced tests, "
            f"{work['visited']} treelet visits of {work['blocks']} blocks), "
            f"{at_sms:.4f} ms counted at the SMs the blocks fill")


def bounce1_span(torch, t_max2):
    """The bounce-1 slice of phase 6, B1_BLOCKS whole 1024-ray blocks
    from the middle of those that hold live and parked lanes: (first ray,
    rays)."""
    block = 1024
    parked = (t_max2 == 0.0).reshape(-1, block).sum(dim=1)
    mixed = torch.nonzero((parked > 0) & (parked < block)).squeeze(1)
    check(mixed.numel() > 0, "bounce 1: no block mixes live and parked lanes")
    a = int(mixed[mixed.numel() // 2]) * block
    return a, min(B1_BLOCKS * block, t_max2.shape[0] - a)


def _per_light(n, n_lights, a, m, fn):
    """Calls fn(lo, hi) on rays [a, a + m) of each light's n rays."""
    def run():
        for li in range(n_lights):
            fn(li * n + a, li * n + a + m)
    return run


def phase_shade_bounces(torch, tsf, scene, cam):
    """The shade kernel against its plain version at every bounce 0-4 of
    the colonnade's first 2048-tile wave, on the lanes path_li hands it
    (the first frame's calls, recorded by _capture), under UniformSampler
    and StratifiedSampler(2, 2) (the sampler's planes): the flag planes
    bit for bit, the others within rtol 2e-6 / atol 1e-7 (the
    transcendentals); each bounce's time beside the plain version's and
    its bound: bytes (the 15 ray/hit/carry planes, prim and ph, the
    sampler's and texture planes in; the 14 + 11L planes out; the shading
    rows of the distinct triangles hit; the tables) against shade_ops.
    Returns the kernels line's entry: the uniform frame's means over the
    bounces, and each bounce's time and bound."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler

    fs = FilmSettings(res=RES, tile_dim=16)
    n_lights = len(scene.meta.light_types)
    flags = [tsf._OUT["alive2"], tsf._OUT["spec2"]] + [
        tsf._N_FIXED_OUT + tsf._N_PER_LIGHT * li + 7
        for li in range(n_lights)]
    entry = None
    for sam_name, sam in (("uniform", UniformSampler(1)),
                          ("strat", StratifiedSampler(2, 2))):
        calls = _capture(torch, lambda: render_frame(
            scene, cam, fs, sam, PathParams(DEPTH), wave_tiles=COL_WAVE_TILES,
            seed=1), {(tsf, "shade_planes"): DEPTH})["shade_planes"]
        check(len(calls) == DEPTH, f"shade {sam_name}: {len(calls)} calls")
        rows = []
        for args in calls:
            tb, rh, prim, ph, texp, dim0, bounce = args[:7]
            spl = args[7] if len(args) > 7 else None

            def kern():
                return tsf.shade_planes(tb, rh, prim, ph, texp, dim0, bounce,
                                        spl)

            def plain():
                return tsf.shade_planes_plain(tb, rh, prim, ph, texp, dim0,
                                              bounce, spl)
            out_k, out_p = kern(), plain()
            torch.cuda.synchronize()
            what = f"shade {sam_name} bounce {bounce}"
            for p in flags:
                check(torch.equal(out_k[p], out_p[p]),
                      f"{what}: flag plane {p} differs")
            err = float((out_k - out_p).abs().max())
            check(torch.allclose(out_k, out_p, rtol=2e-6, atol=1e-7),
                  f"{what}: planes outside rtol 2e-6 / atol 1e-7 (max "
                  f"{err:.3g})")
            ms_k = cuda_ms(torch, kern, 10)
            ms_p = cuda_ms(torch, plain, 1)
            n = rh.shape[1]
            hit_rows = int(torch.unique(prim[prim >= 0]).numel())
            planes_in = 15 + 2 + (0 if spl is None else spl.shape[0]) + (
                0 if texp is None else texp.shape[0])
            nb = (n * 4 * (planes_in + 14 + 11 * n_lights)
                  + hit_rows * tb.trs.shape[1] * 4
                  + nbytes(tb.mat, tb.lt, tb.sp))
            ops = shade_ops(torch, tsf, tb, rh, prim, ph, texp, dim0, bounce,
                            spl)
            b_ms, b_by = bound(nb, ops)
            dead = int((rh[tsf._RH["alive"]] <= 0.0).sum())
            print(f"{what} [{n} lanes, {dead} dead, {hit_rows} distinct "
                  f"triangles]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}; {ops} operations, {nb} "
                  f"bytes), max_abs_err {err:.3g}")
            rows.append((ms_k, ms_p, nb / PEAK_BYTES * 1e3,
                         ops / PEAK_OPS * 1e3, err))
        if entry is None:
            t_bytes = sum(r[2] for r in rows) / len(rows)
            t_ops = sum(r[3] for r in rows) / len(rows)
            entry = dict(
                max_abs_err=max(r[4] for r in rows),
                ms=sum(r[0] for r in rows) / len(rows),
                plain_ms=sum(r[1] for r in rows) / len(rows),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bounce_ms=[r[0] for r in rows],
                bounce_bound_ms=[max(r[2], r[3]) for r in rows])
    return entry


def phase_colonnade_kernels(torch, np, dev, scene, cam):
    """The treelet path's four kernels against their plain versions at
    the main path's shapes, on inputs made by the main path's own code:
    one 2048-tile wave's camera rays, their bounce-0 shading, shadow rays
    and resolve, then the wave's bounce-1 rays and their shadow rays."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace_treelets as ttt
    from yuki_tpu_torch.ops.trace import F32_MAX

    ctx, o, d = _camera_wave(torch, dev, cam, COL_WAVE_TILES)
    n = o.shape[0]
    check(n == COL_WAVE_TILES * 256, f"colonnade wave has {n} rays")
    tl = scene.data.treelets
    boxes = nbytes(tl.super_bounds, tl.super_range, tl.treelet_bounds)
    row_bytes = tl.leaf_size * tl.rows.shape[1] * tl.rows.element_size()

    def walk_bound(stats, rays, ray_bytes):
        # Each ray's planes in and out once, the boxes once, the rows of
        # the treelets some ray needs once; the box and triangle tests
        # each ray's own query needs (the plain walk's tally).
        return bound(rays * ray_bytes + boxes + stats["treelets"] * row_bytes,
                     stats["tests"] * OPS_WATERTIGHT
                     + stats["boxes"] * OPS_SLAB)

    def work(stats):
        return (f"{stats['tests']} triangle tests, {stats['boxes']} box "
                f"tests, {stats['treelets']} treelets")

    result = {}
    sl = SLICE_BLOCKS * ttt.BLOCK
    n_lights = len(scene.meta.light_types)

    # treelet_closest on the camera rays; plain on the first blocks.
    t_max = torch.full((n,), F32_MAX, device=dev)
    got = ttt.treelet_closest(tl, o, d, t_max)
    stats = _compare_closest(torch, tl, got, o, d, t_max, 0, sl,
                             "camera rays")
    ms_full = cuda_ms(torch, lambda: ttt.treelet_closest(tl, o, d, t_max), 3)
    ms_k = cuda_ms(torch, lambda: ttt.treelet_closest(
        tl, o[:sl], d[:sl], t_max[:sl]), 3)
    ms_p = cuda_ms(torch, lambda: ttt.treelet_closest_plain(
        tl, o[:sl], d[:sl], t_max[:sl]), 1)
    b_ms, b_by = walk_bound(stats, sl, CLOSEST_RAY_BYTES)
    print(f"treelet_closest [{n} camera rays: kernel {ms_full:.4f} ms; "
          f"slice of the first {SLICE_BLOCKS} blocks = {sl} rays: kernel "
          f"{ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{work(stats)})]: t, prim, b0, b1 equal on the slice; hits "
          f"{int((got[1] >= 0).sum())}")
    print("  treelet_closest on the camera slice: " + _floor_text(
        torch, treelet_work(torch, tl, (o, d, t_max), [(0, sl)], got)))

    result["treelet_closest"] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                                     bound_ms=b_ms, bound_by=b_by,
                                     wave_ms=ms_full)

    # The vote count that orders the closest walk's blocks, on the same
    # slice.
    stats = {}
    ref = ttt.treelet_votes_plain(tl, o[:sl], d[:sl], t_max[:sl], stats)
    check(torch.equal(ttt.treelet_votes(tl, o[:sl], d[:sl], t_max[:sl]),
                      ref), "treelet_votes differs on the camera slice")
    ms_k = cuda_ms(torch, lambda: ttt.treelet_votes(tl, o[:sl], d[:sl],
                                                   t_max[:sl]), 10)
    ms_p = cuda_ms(torch, lambda: ttt.treelet_votes_plain(
        tl, o[:sl], d[:sl], t_max[:sl]), 1)
    b_ms, b_by = bound(sl * 28 + boxes + ref.numel() * 4,
                       stats["boxes"] * OPS_SLAB)
    print(f"treelet_votes [camera slice, {sl} rays: kernel {ms_k:.4f} ms, "
          f"plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{stats['boxes']} box tests)]: votes equal, a block's "
          f"{int(ref.min())}-{int(ref.max())}")
    result["treelet_votes"] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                                   bound_ms=b_ms, bound_by=b_by)

    # shade at bounces 0-4 of the first wave, on the lanes path_li hands
    # it, whole wave both ways, under both samplers.
    hit = traverse.intersect(scene.data, scene.meta, o, d, t_max,
                             skip_sort=True)
    tables = tsf.make_shade_tables(scene, PathParams(DEPTH))
    ph = _ph_i32(ctx)
    ones = torch.ones_like(o)
    no_spec = torch.zeros_like(hit.hit)
    dim0 = 2
    result["shade"] = phase_shade_bounces(torch, tsf, scene, cam)

    # treelet_any on the bounce-0 shadow rays (light-major, 2N), plain on
    # the first blocks of each light's rays.
    (o2, d2, beta2, alive2, spec2, no, nd, nt, ns_skip, nw, nc,
     ne) = tsf.shade_fused(tables, hit, o, d, ones, hit.hit, no_spec, ph,
                           dim0, 0)
    occ = ttt.treelet_any(tl, no, nd, nt, ns_skip)
    stats = _compare_any(torch, tl, occ, no, nd, nt, ns_skip, n, n_lights,
                         0, sl, "bounce-0 shadow rays")
    ms_full = cuda_ms(torch, lambda: ttt.treelet_any(tl, no, nd, nt, ns_skip),
                      3)

    def slices(fn):
        return _per_light(n, n_lights, 0, sl, lambda lo, hi: fn(
            tl, no[lo:hi], nd[lo:hi], nt[lo:hi], ns_skip[lo:hi]))

    ms_k = cuda_ms(torch, slices(ttt.treelet_any), 3)
    ms_p = cuda_ms(torch, slices(ttt.treelet_any_plain), 1)
    nsl = n_lights * sl
    b_ms, b_by = walk_bound(stats, nsl, ANY_RAY_BYTES)
    print(f"treelet_any [{no.shape[0]} shadow rays, {int(nw.sum())} worth, "
          f"{int(occ.sum())} occluded: kernel {ms_full:.4f} ms; slices of "
          f"the first {SLICE_BLOCKS} blocks of each light = {nsl} rays: "
          f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}; {work(stats)})]: occlusion equal on the slices")
    print("  treelet_any on the bounce-0 shadow slices: " + _floor_text(
        torch, treelet_work(torch, tl, (no, nd, nt, ns_skip),
                            [(li * n, li * n + sl)
                             for li in range(n_lights)], occ)))
    result["treelet_any"] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                                 bound_ms=b_ms, bound_by=b_by,
                                 wave_ms=ms_full)

    # resolve at bounce 0, whole wave both ways.
    occ_all = traverse.any_intersect(scene.data, scene.meta, no, nd, nt,
                                     ns_skip, skip_sort=True)
    rs, nee = tsf.pack_resolve(tables, torch.zeros_like(o), ones, hit.hit,
                               ~hit.hit, ne, occ_all, nw, nc)
    got = tsf.resolve_planes(rs, nee, n_lights, 0, False)
    ref = tsf.resolve_planes_plain(rs, nee, n_lights, 0, False)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "resolve: radiance differs")
    ms_k = cuda_ms(torch, lambda: tsf.resolve_planes(
        rs, nee, n_lights, 0, False), 10)
    ms_p = cuda_ms(torch, lambda: tsf.resolve_planes_plain(
        rs, nee, n_lights, 0, False), 3)
    # Bytes: radiance, beta, alive, missed, emission and the 5L verdict
    # planes in, radiance out; operations: 6 for the miss, 3 per light, 6
    # for the update (no clamp at bounce 0).
    b_ms, b_by = bound(n * 4 * (3 + 3 + 1 + 1 + 3 + 5 * n_lights + 3),
                       n * (12 + 3 * n_lights))
    print(f"resolve [{n} rays]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), radiance equal; mean "
          f"{float(got[:3].mean()):.5f}")
    result["resolve"] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                             bound_ms=b_ms, bound_by=b_by)

    # The wave's bounce-1 rays: divergent, dead lanes parked at the scene
    # centre with t_max 0.  Plain walks on B1_BLOCKS whole blocks that
    # hold both live and parked lanes.
    t_max2 = torch.where(alive2, F32_MAX, 0.0).to(torch.float32)
    got = ttt.treelet_closest(tl, o2, d2, t_max2)
    a, m = bounce1_span(torch, t_max2)
    n_parked = int((t_max2[a:a + m] == 0.0).sum())
    span = f"blocks {a // ttt.BLOCK}-{(a + m) // ttt.BLOCK - 1} = {m} rays"
    stats = _compare_closest(torch, tl, got, o2, d2, t_max2, a, m,
                             "bounce-1 rays")
    ms_full = cuda_ms(torch, lambda: ttt.treelet_closest(tl, o2, d2, t_max2),
                      1)
    ms_k = cuda_ms(torch, lambda: ttt.treelet_closest(
        tl, o2[a:a + m], d2[a:a + m], t_max2[a:a + m]), 3)
    b_ms, b_by = walk_bound(stats, m, CLOSEST_RAY_BYTES)
    print(f"treelet_closest on the wave's bounce-1 rays [{n} rays, "
          f"{int(alive2.sum())} live: kernel {ms_full:.4f} ms; {span}, "
          f"{n_parked} parked with t_max 0: kernel {ms_k:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; {work(stats)})]: t, prim, b0, b1 equal "
          "on the slice")
    print("  treelet_closest on the bounce-1 slice: " + _floor_text(
        torch, treelet_work(torch, tl, (o2, d2, t_max2), [(a, a + m)], got)))

    # ... and their shadow rays, from the main path's bounce-1 shading.
    hit2 = traverse.intersect(scene.data, scene.meta, o2, d2, t_max2,
                              skip_sort=True)
    (_, _, _, _, _, no2, nd2, nt2, sk2, nw2, _,
     _) = tsf.shade_fused(tables, hit2, o2, d2, beta2, alive2 & hit2.hit,
                          spec2, ph, dim0 + 2 * n_lights + 3, 1)
    occ2 = ttt.treelet_any(tl, no2, nd2, nt2, sk2)
    stats = _compare_any(torch, tl, occ2, no2, nd2, nt2, sk2, n, n_lights,
                         a, m, "bounce-1 shadow rays")
    n_parked = sum(int((nt2[li * n + a:li * n + a + m] == 0.0).sum())
                   for li in range(n_lights))
    ms_full = cuda_ms(torch, lambda: ttt.treelet_any(tl, no2, nd2, nt2, sk2),
                      1)
    ms_k = cuda_ms(torch, _per_light(n, n_lights, a, m, lambda lo, hi:
                                     ttt.treelet_any(tl, no2[lo:hi],
                                                     nd2[lo:hi], nt2[lo:hi],
                                                     sk2[lo:hi])), 3)
    b_ms, b_by = walk_bound(stats, n_lights * m, ANY_RAY_BYTES)
    print(f"treelet_any on the wave's bounce-1 shadow rays [{no2.shape[0]} "
          f"rays, {int(nw2.sum())} worth, {int(occ2.sum())} occluded: kernel "
          f"{ms_full:.4f} ms; {span} of each light, {n_parked} parked with "
          f"t_max 0: kernel {ms_k:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{work(stats)})]: occlusion equal on the slices")
    print("  treelet_any on the bounce-1 shadow slices: " + _floor_text(
        torch, treelet_work(torch, tl, (no2, nd2, nt2, sk2),
                            [(li * n + a, li * n + a + m)
                             for li in range(n_lights)], occ2)))
    return result, (o2, d2, t_max2, no2, nd2, nt2, sk2), (
        o, d, t_max, no, nd, nt, ns_skip)


def phase_stream_kernels(torch, np, scene, rays, card):
    """The divergent-wave kernels against their plain versions on the
    wave's bounce-1 rays and their shadow rays, with the plain versions'
    tallies for the bounds."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_cull as tcu
    from yuki_tpu_torch.ops import trace_stream as ts

    o2, d2, t2, no2, nd2, nt2, sk2 = rays
    ch, meta = scene.data.chunks, scene.meta
    n = o2.shape[0]
    w = ts.n_words(ch.n_treelets)
    tables = nbytes(ch.treelet_bounds) + w * 8 * 4  # chunk and word boxes
    waves = {"bounce-1 rays": (o2, d2, t2), "shadow rays": (no2, nd2, nt2)}
    result = {}

    lists = {}
    for what, (o, d, t) in waves.items():
        got = tcu.candidate_lists_fused(ch, o, d, t, ts.C_MAIN)
        stats = {}
        ref = tcu.candidate_lists_2l(ch, o, d, t, ts.C_MAIN, stats=stats)
        torch.cuda.synchronize()
        check(torch.equal(got[0], ref[0]), f"cull on {what}: lists differ")
        check(torch.equal(got[1], ref[1]), f"cull on {what}: overflow differs")
        ms_k = cuda_ms(torch, lambda: tcu.candidate_lists_fused(
            ch, o, d, t, ts.C_MAIN), 10)
        ms_p = cuda_ms(torch, lambda: tcu.candidate_lists_2l(
            ch, o, d, t, ts.C_MAIN), 1)
        m = o.shape[0]
        b_ms, b_by = bound(m * 28 + m * (4 * ts.C_MAIN + 1) + tables,
                           stats["boxes"] * OPS_SLAB)
        # The same rays sorted by the coherence key, lists permuted back.
        order = torch.argsort(traverse.ray_sort_key(scene.data, o, d),
                              stable=True)
        so, sd, st_ = (x[order].contiguous() for x in (o, d, t))
        s_l, s_ov = tcu.candidate_lists_fused(ch, so, sd, st_, ts.C_MAIN)
        back_l, back_ov = torch.empty_like(s_l), torch.empty_like(s_ov)
        back_l[order] = s_l
        back_ov[order] = s_ov
        torch.cuda.synchronize()
        check(torch.equal(back_l, got[0]) and torch.equal(back_ov, got[1]),
              f"cull on sorted {what}: lists or overflow differ")
        ms_s = cuda_ms(torch, lambda: tcu.candidate_lists_fused(
            ch, so, sd, st_, ts.C_MAIN), 10)
        print(f"cull [{m} {what}, {int((t > 0).sum())} live, "
              f"{int(got[1].sum())} overflow]: kernel {ms_k:.4f} ms, plain "
              f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {stats['boxes']} "
              f"slab tests): lists and overflow equal; sorted by "
              f"ray_sort_key: kernel {ms_s:.4f} ms, lists equal permuted "
              f"back [{card}]")
        if what == "bounce-1 rays":
            result["cull"] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                                  bound_ms=b_ms, bound_by=b_by)
        lists[what] = got

    idx = torch.nonzero(lists["bounce-1 rays"][1]).squeeze(1)
    sl = SLICE_BLOCKS * 1024
    for what, sel in (("the cull's overflow mini-wave", idx),
                      (f"a {SLICE_BLOCKS}-block slice", slice(0, sl))):
        o, d, t = (x[sel].contiguous() for x in (o2, d2, t2))
        m = o.shape[0]
        check(m > 0, f"cross_words: {what} is empty")
        got = ts.cross_words(ch, o, d, t)
        stats = {}
        ref = ts.cross_words_plain(ch, o, d, t, stats)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"cross_words on {what}: words differ")
        ms_k = cuda_ms(torch, lambda: ts.cross_words(ch, o, d, t), 10)
        ms_p = cuda_ms(torch, lambda: ts.cross_words_plain(ch, o, d, t), 3)
        b_ms, b_by = bound(m * 28 + m * w * 4 + tables,
                           stats["boxes"] * OPS_SLAB)
        print(f"cross_words [{what}: {m} bounce-1 rays]: kernel {ms_k:.4f} "
              f"ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{stats['boxes']} slab tests): words equal [{card}]")
        result["cross_words"] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                                     bound_ms=b_ms, bound_by=b_by)

    k = ch.leaf_size
    budgets = {"bounce-1 rays": (meta.slot_mult_tight, meta.slot_mult),
               "shadow rays": (max(3, meta.slot_mult_tight - 1),
                               max(4, meta.slot_mult - 2))}
    for what, name in (("bounce-1 rays", "slot_closest"),
                       ("shadow rays", "slot_any")):
        o, d, t = waves[what]
        m = o.shape[0]
        slots = ts._slots(ch, lists[what][0], ts.C_MAIN, *budgets[what], m)
        check(slots is not None, f"{name}: the {what}' slot budget blew")
        _, slot_ray, row_chunk, valid = slots
        extra = sk2 if name == "slot_any" else None
        stream = ts._pack_stream(o, d, t, slot_ray, valid, extra=extra)
        kern = getattr(ts, name)
        plain = getattr(ts, name + "_plain")
        got = kern(ch.rows, k, row_chunk, stream)
        stats = {}
        ref = plain(ch.rows, k, row_chunk, stream, stats)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"{name} on the {what}' slots differs")
        ms_k = cuda_ms(torch, lambda: kern(ch.rows, k, row_chunk, stream), 10)
        ms_p = cuda_ms(torch, lambda: plain(ch.rows, k, row_chunk, stream), 1)
        n_slots = stream.shape[0]
        chunks = int(torch.unique(row_chunk).numel())
        out_b = 12 if name == "slot_closest" else 4
        ops = OPS_SCALED if name == "slot_closest" else OPS_SCALED - 1
        b_ms, b_by = bound(n_slots * (32 + out_b) + row_chunk.numel() * 4
                           + chunks * k * 48, stats["tests"] * ops)
        print(f"{name} [{m} {what}: {row_chunk.numel()} slot rows, "
              f"{int(valid.sum())} valid slots, {int((stream[:, 6] > 0).sum())}"
              f" live, {chunks} chunks]: kernel {ms_k:.4f} ms, plain "
              f"{ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {stats['tests']} "
              f"triangle tests): {'ts, prim, det' if out_b == 12 else 'occlusion'}"
              f" equal on every slot [{card}]")
        result[name] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                            bound_ms=b_ms, bound_by=b_by)

    # The closest walk, both instantiations (skip -2 skips nothing), on
    # the bounce-1 wave's slots and on the overflow rays' wide re-run
    # (C_WIDE), laid out as traverse._closest_dispatch lays them out.
    ow, dw, tw_ = (x[idx].contiguous() for x in (o2, d2, t2))
    w_lists, _ = ts.extract_lists(ts.cross_words(ch, ow, dw, tw_), ts.C_WIDE)
    sets = {
        "the bounce-1 rays' slots": (ts._slots(
            ch, lists["bounce-1 rays"][0], ts.C_MAIN,
            *budgets["bounce-1 rays"], n), (o2, d2, t2)),
        "the overflow rays' wide re-run slots": (ts._slots(
            ch, w_lists, ts.C_WIDE, (ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT),
            ts.C_WIDE, traverse._wide_cap(int(idx.numel()))), (ow, dw, tw_)),
    }
    for what, (slots, (so, sd, st_)) in sets.items():
        check(slots is not None, f"slot_closest: {what}: the budget blew")
        _, slot_ray, row_chunk, valid = slots
        neutral = torch.full((so.shape[0],), -2, dtype=torch.int32,
                             device=so.device)
        stream = ts._pack_stream(so, sd, st_, slot_ray, valid, extra=neutral)
        times = []
        for skip in (False, True):
            got = ts.slot_closest(ch.rows, k, row_chunk, stream, skip)
            ref = ts.slot_closest_plain(ch.rows, k, row_chunk, stream,
                                        with_skip=skip)
            torch.cuda.synchronize()
            check(torch.equal(got, ref), f"slot_closest (with_skip {skip}) "
                  f"on {what} differs from its plain version")
            times.append(cuda_ms(torch, lambda: ts.slot_closest(
                ch.rows, k, row_chunk, stream, skip), 10))
        print(f"slot_closest on {what} [{row_chunk.numel()} rows, "
              f"{int((stream[:, 6] > 0).sum())} live slots]: kernel "
              f"{times[0]:.4f} ms, with_skip {times[1]:.4f} ms: both equal "
              f"their plain versions bit for bit [{card}]")
    return result


def phase_dispatch_vs_walk(torch, scene, rays, card):
    """The dispatch's divergent branch against the treelet walk on the
    wave's bounce-1 rays and their shadow rays.  The engines are both
    exact; a prim may differ only where two triangles lie at the same
    distance to within an ulp (the slot merge takes the lower id among
    equal t, the walk the first it meets), and t by an ulp (one IEEE
    divide of a scaled hit against a multiply by a reciprocal)."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_treelets as ttt

    o2, d2, t2, no2, nd2, nt2, sk2 = rays
    data, tl = scene.data, scene.data.treelets
    traverse.reset_counts()
    t_s, p_s, b0_s, b1_s = traverse._closest_dispatch(data, scene.meta, o2,
                                                      d2, t2)
    t_w, p_w, b0_w, b1_w = ttt.treelet_closest(tl, o2, d2, t2)
    occ_s = traverse._any_dispatch(data, scene.meta, no2, nd2, nt2, sk2)
    occ_w = ttt.treelet_any(tl, no2, nd2, nt2, sk2)
    torch.cuda.synchronize()
    c = traverse.counts()
    check(c["closest_slot"] == 1 and c["any_slot"] == 1 and not c["fallbacks"],
          f"dispatch: bounce-1 waves did not take the slot branch: {c}")
    ulp = (t_s.view(torch.int32) - t_w.view(torch.int32)).abs()
    same = p_s == p_w
    ties = ~same & (ulp <= 1)
    n_diff, n_ties = int((~same).sum()), int(ties.sum())
    check(n_diff == n_ties, f"dispatch vs walk: {n_diff - n_ties} prim "
          "differences that are not ties")
    max_ulp = int(ulp[same].max())
    check(max_ulp <= 1, f"dispatch vs walk: t {max_ulp} ulps apart")
    check(torch.equal(b0_s[same], b0_w[same])
          and torch.equal(b1_s[same], b1_w[same]),
          "dispatch vs walk: b0/b1 differ where prim is equal")
    n_occ = int((occ_s != occ_w).sum())
    check(n_occ == 0, f"dispatch vs walk: {n_occ} occlusion verdicts differ")
    print(f"dispatch vs treelet walk [{o2.shape[0]} bounce-1 rays, "
          f"{int((p_s >= 0).sum())} hits; {no2.shape[0]} shadow rays, "
          f"{int(occ_s.sum())} occluded]: prim differs at {n_ties} ties "
          f"(t within 1 ulp), t gap at most {max_ulp} ulp where prim is "
          f"equal ({int((same & (ulp == 1)).sum())} rays at 1 ulp), b0/b1 "
          f"equal there, occlusion equal; {c['overflow_rays']} overflow "
          f"rays, {c['wide_reruns']} wide re-runs [{card}]")

    profile_queries(torch, card, (
        ("closest, bounce-1 rays", lambda: traverse._closest_dispatch(
            data, scene.meta, o2, d2, t2)),
        ("occlusion, shadow rays", lambda: traverse._any_dispatch(
            data, scene.meta, no2, nd2, nt2, sk2))))


def profile_queries(torch, card, calls):
    """Each query as path_li makes it: time per call from CUDA events (the
    host reads inside it stall the stream, so they are included), then
    one call under torch.profiler for where its device time goes."""
    from torch.profiler import ProfilerActivity, profile

    for what, call in calls:
        ms = cuda_ms(torch, call, 3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        groups, _ = device_breakdown(torch, prof)
        busy = sum(ms_k for ms_k, _ in groups.values())
        parts = ", ".join(f"{k} {ms_k:.3f} ms / {cnt}"
                          for k, (ms_k, cnt) in groups.items() if cnt)
        print(f"dispatch {what}: {ms:.3f} ms per call, device busy "
              f"{busy:.3f} ms (kernels: {parts}) [{card}]")


def phase_rows_kernels(torch, scene, wave0, card):
    """The row-union kernels against their plain versions on the wave's
    camera rays (the probe's own words, which must call the wave
    coherent) and its bounce-0 shadow rays (forced through the rows
    engine, whatever the probe says), then the dispatch on those waves
    against the treelet walk under phase 8's rules.  Bounds: the plain
    walks' tally of rechecks (24 operations) and triangle tests (40; 39
    for occlusion); bytes: rays in, results out, the kept lists and the
    rows of every chunk the lists name once."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_rows as trw
    from yuki_tpu_torch.ops import trace_treelets as ttt

    o, d, t_max, no, nd, nt, sk = wave0
    data, tl, ch = scene.data, scene.data.treelets, scene.data.chunks
    k = ch.leaf_size
    skf = sk.to(torch.float32)
    result = {}
    for name, (ro, rd, rt, what) in (
            ("rows_closest", (o, d, t_max, "camera rays")),
            ("rows_any", (no, nd, nt, "bounce-0 shadow rays"))):
        m = ro.shape[0]
        words = trw.row_words_interval(ch, ro, rd, rt)
        rows = words.shape[0]
        demand = int(traverse._rows_demand(words))
        coherent = demand <= rows * traverse._ROWS_MULT
        if name == "rows_closest":
            check(coherent, f"rows: the camera wave's demand {demand} is "
                  f"past the rows budget {rows * traverse._ROWS_MULT}")
        lists, ov = trw.kept_lists(words, traverse._ROWS_C,
                                   traverse._ROWS_MULT)
        if name == "rows_closest":
            def kern():
                return trw.rows_closest_walk(ch, lists, ro, rd, rt)

            def plain(stats=None):
                return trw.rows_closest_walk_plain(ch, lists, ro, rd, rt,
                                                   stats)
        else:
            def kern():
                return trw.rows_any_walk(ch, lists, ro, rd, rt, skf)

            def plain(stats=None):
                return trw.rows_any_walk_plain(ch, lists, ro, rd, rt, skf,
                                               stats)
        got = kern()
        stats = {}
        ref = plain(stats)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"{name} on the {what} differs from its "
              "plain version")
        ms_k = cuda_ms(torch, kern, 10)
        ms_p = cuda_ms(torch, plain, 1)
        chunks = int(torch.unique(lists[lists >= 0]).numel())
        out_b = 12 if name == "rows_closest" else 4
        ops = OPS_SCALED if name == "rows_closest" else OPS_SCALED - 1
        b_ms, b_by = bound(m * (28 + (4 if name == "rows_any" else 0) + out_b)
                           + lists.numel() * 4 + chunks * k * 48,
                           stats["boxes"] * OPS_SLAB + stats["tests"] * ops)
        found = (f"{int((got[1] >= 0).sum())} hits" if name == "rows_closest"
                 else f"{int(got.sum())} occluded")
        print(f"{name} [{m} {what}, {rows} rows, pair demand {demand} against "
              f"the budget {rows * traverse._ROWS_MULT} (coherent: "
              f"{coherent}), {int(ov.sum())} overflow rows, {chunks} chunks "
              f"listed, {found}]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}; {stats['boxes']} rechecks, "
              f"{stats['tests']} triangle tests; ptxas "
              f"{ptxas_usage(name + '_kernel')}): "
              f"{'ts, prim, det' if out_b == 12 else 'occlusion'} equal on "
              f"every ray [{card}]")
        result[name] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                            bound_ms=b_ms, bound_by=b_by)

    # The dispatch on the coherent waves against the treelet walk.
    traverse.reset_counts()
    t_s, p_s, b0_s, b1_s = traverse._closest_dispatch(data, scene.meta, o, d,
                                                      t_max)
    c = traverse.counts()
    occ_s = traverse._any_dispatch(data, scene.meta, no, nd, nt, sk)
    t_w, p_w, b0_w, b1_w = ttt.treelet_closest(tl, o, d, t_max)
    occ_w = ttt.treelet_any(tl, no, nd, nt, sk)
    torch.cuda.synchronize()
    c2 = traverse.counts()
    check(c["closest_rows"] == 1 and not c["fallbacks"],
          f"dispatch: the camera wave did not take the rows branch: {c}")
    ulp = (t_s.view(torch.int32) - t_w.view(torch.int32)).abs()
    same = p_s == p_w
    ties = ~same & (ulp <= 1)
    n_diff, n_ties = int((~same).sum()), int(ties.sum())
    check(n_diff == n_ties, f"rows dispatch vs walk: {n_diff - n_ties} prim "
          "differences that are not ties")
    max_ulp = int(ulp[same].max())
    check(max_ulp <= 1, f"rows dispatch vs walk: t {max_ulp} ulps apart")
    check(torch.equal(b0_s[same], b0_w[same])
          and torch.equal(b1_s[same], b1_w[same]),
          "rows dispatch vs walk: b0/b1 differ where prim is equal")
    n_occ = int((occ_s != occ_w).sum())
    check(n_occ == 0, f"rows dispatch vs walk: {n_occ} occlusion verdicts "
          "differ")
    branch = "rows" if c2["any_rows"] else "slot"
    print(f"dispatch vs treelet walk on coherent waves [{o.shape[0]} camera "
          f"rays, {int((p_s >= 0).sum())} hits, rows branch; {no.shape[0]} "
          f"bounce-0 shadow rays, {int(occ_s.sum())} occluded, {branch} "
          f"branch]: prim differs at {n_ties} ties (t within 1 ulp), t gap at "
          f"most {max_ulp} ulp where prim is equal "
          f"({int((same & (ulp == 1)).sum())} rays at 1 ulp), b0/b1 equal "
          f"there, occlusion equal; {c2['overflow_rays']} overflow rays, "
          f"{c2['wide_reruns']} wide re-runs, {c2['fallbacks']} fallbacks "
          f"[{card}]")
    profile_queries(torch, card, (
        ("closest, camera rays", lambda: traverse._closest_dispatch(
            data, scene.meta, o, d, t_max)),
        ("occlusion, bounce-0 shadow rays", lambda: traverse._any_dispatch(
            data, scene.meta, no, nd, nt, sk))))
    return result


def _walker_flags(on):
    from yuki_tpu_torch import traverse

    traverse.WALKER_CLOSEST = traverse.WALKER_ANY = on


def phase_walker(torch, scene, rays, wave0, card):
    """The bundle walks against their plain versions on the wave's
    bounce-1 rays (closest) and its bounce-0 shadow rays (occlusion),
    with the lists the walker makes from the crossing words (C_WALK) and
    its budget verdict at the dispatch's tiers, the share of list entries
    walked and the live rays a walked entry; bounds from the plain walks'
    tallies (24 operations a box recheck, 40 a scaled test, 39 for
    occlusion; bytes: rays in, results out, the lists, the rows of every
    chunk the lists name once).  Then the dispatch with both walker flags
    against the dispatch without them on the bounce-1 rays and their
    shadow rays, under phase 8's rules, and each walker query's time per
    call and device breakdown."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_stream as ts
    from yuki_tpu_torch.ops import trace_walker as tw

    o2, d2, t2, no2, nd2, nt2, sk2 = rays
    _, _, _, no, nd, nt, sk = wave0
    data, ch = scene.data, scene.data.chunks
    k = ch.leaf_size
    result = {}
    for name, (ro, rd, rt, rs, what, mults) in (
            ("walker_closest", (o2, d2, t2, None, "bounce-1 rays",
                                traverse.WALKER_MULT)),
            ("walker_any", (no, nd, nt, sk.to(torch.float32),
                            "bounce-0 shadow rays",
                            traverse.WALKER_MULT_ANY))):
        m = ro.shape[0]
        lists, ov = tw.walker_lists(ts.cross_words(ch, ro, rd, rt), tw.C_WALK)
        ok = bool(tw.budget_ok(lists, *mults))
        if name == "walker_closest":
            def kern():
                return tw.walker_closest_walk(ch, lists, ro, rd, rt)

            def plain(stats=None):
                return tw.walker_closest_plain(ch, lists, ro, rd, rt, stats)
        else:
            def kern():
                return tw.walker_any_walk(ch, lists, ro, rd, rt, rs)

            def plain(stats=None):
                return tw.walker_any_plain(ch, lists, ro, rd, rt, rs, stats)
        got = kern()
        stats = {}
        ref = plain(stats)
        torch.cuda.synchronize()
        if name == "walker_closest":
            for g, r, f in zip(got, ref, ("t", "prim")):
                check(torch.equal(g, r), f"{name} on the {what}: {f} differs "
                      "from the plain version")
            found = f"{int((got[1] >= 0).sum())} hits"
            out_b, ops = 8, OPS_SCALED
        else:
            check(torch.equal(got, ref), f"{name} on the {what}: occlusion "
                  "differs from the plain version")
            found = f"{int(got.sum())} occluded"
            out_b, ops = 4, OPS_SCALED - 1
        ms_k = cuda_ms(torch, kern, 10)
        ms_p = cuda_ms(torch, plain, 1)
        chunks = int(torch.unique(lists[lists >= 0]).numel())
        pairs = int((lists >= 0).sum())
        b_ms, b_by = bound(m * (28 + (4 if rs is not None else 0) + out_b)
                           + lists.numel() * 4 + chunks * k * 48,
                           stats["boxes"] * OPS_SLAB + stats["tests"] * ops)
        walked = stats["walked"]
        print(f"{name} [{m} {what}, {lists.shape[0]} bundles, {pairs} "
              f"(bundle, chunk) pairs, {int(ov.sum())} overflow rays, budget "
              f"at tiers {mults}: ok {ok}, {chunks} chunks listed, {found}; "
              f"walked {walked} of {stats['entries']} list entries "
              f"({walked / max(1, stats['entries']):.4f}), "
              f"{stats['live'] / max(1, walked):.3f} live rays a walked "
              f"entry]: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {stats['boxes']} rechecks, "
              f"{stats['tests']} triangle tests): equal bit for bit [{card}]")
        result[name] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                            bound_ms=b_ms, bound_by=b_by)

    # The dispatch with the walker against the dispatch without it.
    out = {}
    for on in (False, True):
        _walker_flags(on)
        try:
            traverse.reset_counts()
            hit = traverse._closest_dispatch(data, scene.meta, o2, d2, t2)
            occ = traverse._any_dispatch(data, scene.meta, no2, nd2, nt2, sk2)
            torch.cuda.synchronize()
            out[on] = (hit, occ, traverse.counts())
        finally:
            _walker_flags(False)
    (t_s, p_s, b0_s, b1_s), occ_s, c_s = out[False]
    (t_w, p_w, b0_w, b1_w), occ_w, c_w = out[True]
    check(c_w["closest_walker"] == 1 and c_w["any_walker"] == 1
          and not c_w["fallbacks"],
          f"walker dispatch: the bounce-1 waves did not take the walker: {c_w}")
    ulp = (t_s.view(torch.int32) - t_w.view(torch.int32)).abs()
    same = p_s == p_w
    ties = ~same & (ulp <= 1)
    n_diff, n_ties = int((~same).sum()), int(ties.sum())
    check(n_diff == n_ties, f"walker dispatch vs slot stream: "
          f"{n_diff - n_ties} prim differences that are not ties")
    max_ulp = int(ulp[same].max())
    check(max_ulp <= 1, f"walker dispatch vs slot stream: t {max_ulp} ulps "
          "apart")
    check(torch.equal(b0_s[same], b0_w[same])
          and torch.equal(b1_s[same], b1_w[same]),
          "walker dispatch vs slot stream: b0/b1 differ where prim is equal")
    n_occ = int((occ_s != occ_w).sum())
    check(n_occ == 0, f"walker dispatch vs slot stream: {n_occ} occlusion "
          "verdicts differ")
    print(f"dispatch with the walker vs the slot stream [{o2.shape[0]} "
          f"bounce-1 rays, {int((p_w >= 0).sum())} hits; {no2.shape[0]} "
          f"shadow rays, {int(occ_w.sum())} occluded]: prim differs at "
          f"{n_ties} ties (t within 1 ulp), largest t gap {max_ulp} ulp where "
          f"prim is equal ({int((same & (ulp == 1)).sum())} rays at 1 ulp), "
          f"b0/b1 equal there, occlusion equal; walker {c_w['overflow_rays']} "
          f"overflow rays, {c_w['wide_reruns']} wide re-runs; slot stream "
          f"{c_s['overflow_rays']} overflow rays, {c_s['wide_reruns']} wide "
          f"re-runs [{card}]")
    _walker_flags(True)
    try:
        profile_queries(torch, card, (
            ("closest with the walker, bounce-1 rays",
             lambda: traverse._closest_dispatch(data, scene.meta, o2, d2,
                                                t2)),
            ("occlusion with the walker, shadow rays",
             lambda: traverse._any_dispatch(data, scene.meta, no2, nd2, nt2,
                                            sk2))))
    finally:
        _walker_flags(False)
    return result


def phase_colonnade_golden(torch, np, scene, cam, walker=False):
    """The colonnade golden, with the dispatch's divergent branch on the
    slot stream or (``walker``) on the bundle walker; returns the
    divergent pixel count."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler

    _walker_flags(walker)
    try:
        traverse.reset_counts()
        res = render_frame(scene, cam,
                           FilmSettings(res=(64, 48), tile_dim=16),
                           UniformSampler(1), PathParams(3), wave_tiles=12,
                           seed=1)
        c = traverse.counts()
    finally:
        _walker_flags(False)
    check(c["closest_walker"] + c["any_walker"] > 0 if walker else
          c["closest_walker"] + c["any_walker"] == 0,
          f"colonnade golden (walker {walker}): dispatch {c}")
    img = res.film.image()
    gold = np.load(COL_GOLDEN)["img"]
    check(img.shape == gold.shape, f"colonnade golden: shape {img.shape}")
    check(np.isfinite(img).all(), "colonnade golden: non-finite pixels")
    n_bad, limit, mean_rel = deep_parity(np, gold, img)
    rmse = float(np.sqrt(np.mean((img - gold) ** 2)))
    engine = "the bundle walker" if walker else "the slot stream"
    print(f"golden colonnade 64x48 d3 1spp seed 1 (divergent waves on "
          f"{engine}): divergent px {n_bad} (limit {limit}), mean rel diff "
          f"{mean_rel:.3g}, rmse {rmse:.4g}; dispatch {c}")
    return n_bad


KERNEL_FAMILIES = ("cull", "cross_words", "slot_closest", "slot_any",
                   "rows_closest", "rows_any", "treelet_closest",
                   "treelet_any", "treelet_votes", "shade", "resolve",
                   "dense_closest", "dense_any", "walker_closest",
                   "walker_any")
GLUE_FAMILIES = (("glue: sort", ("sort",)),
                 ("glue: scatter/gather/index", ("scatter", "gather",
                                                 "index")),
                 ("glue: memcpy/memset", ("memcpy", "memset")))


def device_breakdown(torch, prof):
    """Device time (ms) and kernel count by family from a torch.profiler
    run: {family: [ms, launches]}, over the device's own events (a torch
    operator's entry repeats the time of the kernels it launched); torch's
    kernels split into sorts, scatters/gathers/indexing, copies and the
    rest.  Also the torch operators that launched the most device time:
    [(ms, calls, name)].  The pass_scope ranges' device spans repeat their
    kernels' time too and are left out."""
    from yuki_tpu_torch.profiling import SCOPES

    names = [*KERNEL_FAMILIES, *(g for g, _ in GLUE_FAMILIES), "glue: other"]
    groups = {k: [0.0, 0] for k in names}
    glue = []
    for e in prof.key_averages():
        t = float(getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3
        if t <= 0.0 or getattr(e, "is_user_annotation", False) or \
                e.key in SCOPES:
            continue
        if e.device_type == torch.autograd.DeviceType.CPU:
            if e.key.startswith("aten::"):
                glue.append((t, e.count, e.key))
            continue
        low = e.key.lower()
        key = next((k for k in KERNEL_FAMILIES if f"{k}_kernel" in e.key),
                   None) or next((g for g, words in GLUE_FAMILIES
                                  if any(wd in low for wd in words)),
                                 "glue: other")
        groups[key][0] += t
        groups[key][1] += e.count
    return groups, sorted(glue, reverse=True)[:8]


def phase_colonnade_main_path(torch, np, scene, cam, card, walker=False):
    """The treelet main path: one colonnade frame with its launches and
    the dispatch's branch counts, then the same frame under
    torch.profiler.  With ``walker`` the dispatch's divergent branch takes
    the bundle walker (WALKER_CLOSEST / WALKER_ANY), and that frame is the
    walker kernels' main path."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace_cull as tcu
    from yuki_tpu_torch.ops import trace_rows as trw
    from yuki_tpu_torch.ops import trace_stream as ts
    from yuki_tpu_torch.ops import trace_treelets as ttt
    from yuki_tpu_torch.ops import trace_walker as tw
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler

    fs = FilmSettings(res=RES, tile_dim=16)
    engine = "walker" if walker else "slot stream"

    def frame():
        return render_frame(scene, cam, fs, UniformSampler(1),
                            PathParams(max_depth=DEPTH),
                            wave_tiles=COL_WAVE_TILES, seed=1)

    _walker_flags(walker)
    try:
        torch.cuda.synchronize()
        reset_all_launches()
        res = frame()
        torch.cuda.synchronize()
        counts = all_launches()
        branches = traverse.counts()
        # The slot walks and the crossing words also serve the wide
        # re-run, which the walker's overflow rays take.
        used = tuple(k for k in (
            (*tw.LAUNCHES, *tsf.LAUNCHES, *trw.LAUNCHES) if walker else
            (*tsf.LAUNCHES, *tcu.LAUNCHES, *ts.LAUNCHES, *trw.LAUNCHES))
            if k not in SKIP_KERNELS)
        optional = (*ttt.LAUNCHES, *ts.LAUNCHES) if walker else ttt.LAUNCHES
        launches = {k: counts[k] for k in (*ttt.LAUNCHES, *used)}
        walks = counts["treelet_closest"] + counts["treelet_any"]
        check(walks == branches["fallbacks"] and counts["treelet_votes"]
              == counts["treelet_closest"], f"colonnade main path ({engine}):"
              f" {walks} treelet walks and {counts['treelet_votes']} vote "
              f"counts for {branches['fallbacks']} fallbacks")
        for name, count in counts.items():
            if name in optional:
                continue
            if name in used:
                check(count > 0, f"colonnade main path ({engine}): {name} "
                      "never launched")
            else:
                check(count == 0, f"colonnade main path ({engine}): {name} "
                      "launched")
        img = res.film.image()
        check(img.shape == (RES[1], RES[0], 3),
              f"colonnade main path: shape {img.shape}")
        check(np.isfinite(img).all(), "colonnade main path: non-finite pixels")
        check(float(img.mean()) > 0.0, "colonnade main path: black image")
        mrays = res.ray_count / res.elapsed_s / 1e6
        print(f"main path colonnade {RES[0]}x{RES[1]} d{DEPTH} 1spp "
              f"{COL_WAVE_TILES}-tile waves, divergent waves on the {engine}:"
              f" {res.ray_count} closest-hit rays in {res.elapsed_s:.3f} s = "
              f"{mrays:.2f} Mrays/s, {1.0 / res.elapsed_s:.3f} spp/s, "
              f"{res.elapsed_s:.3f} s/frame, launches {launches}, dispatch "
              f"{branches}, image mean {float(img.mean()):.5f} [{card}]")

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            frame()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        _walker_flags(False)
    groups, top_ops = device_breakdown(torch, prof)
    busy = sum(v[0] for v in groups.values())
    if busy > 0.0:
        parts = ", ".join(
            f"{k} {ms:.3f} ms / {cnt} kernels = {ms / max(cnt, 1):.3f} ms each"
            for k, (ms, cnt) in groups.items() if cnt)
        print(f"colonnade frame ({engine}) under torch.profiler: wall "
              f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms "
              f"({100 * busy / wall / 1e3:.1f}%; idle share "
              f"{100 * (1 - busy / wall / 1e3):.1f}% of this frame, "
              f"{100 * (1 - busy / res.elapsed_s / 1e3):.1f}% of the "
              f"unprofiled frame's {res.elapsed_s * 1e3:.3f} ms): {parts} "
              f"[{card}]")
        print(f"torch operators by device time ({engine}): " + "; ".join(
            f"{name} {ms:.3f} ms / {cnt} calls" for ms, cnt, name in top_ops))
    else:
        print("colonnade frame under torch.profiler: no device time recorded "
              "(device breakdown not measured)")
    return {k: launches[k] for k in (("walker_closest", "walker_any")
                                     if walker else launches)}


def phase_colonnade_strat(torch, np, scene, cam, card):
    """One 1080p colonnade frame at depth DEPTH with StratifiedSampler(2,
    2) (4 spp) through path_li, timed: the shade kernel reads each
    bounce's values as planes."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import StratifiedSampler

    torch.cuda.synchronize()
    reset_all_launches()
    res = render_frame(scene, cam, FilmSettings(res=RES, tile_dim=16),
                       StratifiedSampler(2, 2), PathParams(max_depth=DEPTH),
                       wave_tiles=COL_WAVE_TILES, seed=1)
    torch.cuda.synchronize()
    counts = all_launches()
    check(counts["shade"] > 0 and counts["resolve"] > 0,
          "stratified colonnade frame: shade/resolve never launched")
    img = res.film.image()
    check(np.isfinite(img).all() and float(img.mean()) > 0.0,
          "stratified colonnade frame: non-finite or black image")
    print(f"colonnade {RES[0]}x{RES[1]} d{DEPTH} 4spp StratifiedSampler(2, 2)"
          f" {COL_WAVE_TILES}-tile waves through path_li: {res.ray_count} "
          f"closest-hit rays in {res.elapsed_s:.3f} s = "
          f"{res.ray_count / res.elapsed_s / 1e6:.2f} Mrays/s, "
          f"{res.elapsed_s / 4:.3f} s per sample, launches "
          f"{ {k: counts[k] for k in tsf.LAUNCHES} }, dispatch "
          f"{traverse.counts()}, image mean {float(img.mean()):.5f} [{card}]")


def timed_once(torch, fn):
    """(fn's result, the device time of that one call in ms, CUDA
    events): for plain versions, which are slow and run once."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _combine(torch, co, cd, ct, so, sd, st, ss):
    """A combined wave: closest lanes with skip -2, then shadow lanes."""
    skip = torch.full((co.shape[0],), -2, dtype=torch.int32,
                      device=co.device)
    return [torch.cat(x).contiguous() for x in
            ((co, so), (cd, sd), (ct, st), (skip, ss))]


def _same_hits(torch, a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("hit", "t", "prim", "sphere", "b0", "b1"))


def _engine(name):
    """Set the dispatch's divergent branch for a with-block: "walker" sets
    both walker flags, "fallback" gives the slot stream a budget of zero
    rows (every divergent wave falls back to the treelet walk)."""
    import contextlib

    from yuki_tpu_torch.ops import trace_stream as ts

    @contextlib.contextmanager
    def ctx():
        saved = ts._max_rows
        if name == "fallback":
            ts._max_rows = lambda *a: 0
        _walker_flags(name == "walker")
        try:
            yield
        finally:
            ts._max_rows = saved
            _walker_flags(False)
    return ctx()


def phase_combined(torch, scene, rays, wave0, card):
    """12. The combined wave on the colonnade: the 2048-tile wave's 524,288
    bounce-1 closest lanes (skip -2) and their 1,048,576 NEE shadow lanes
    (the rect light's id or -2 for the distant light, the 0.9999 chord),
    skip_sort=True, bary_count = the closest lanes, on the slot stream,
    the walker and the fallback (each forced, see _engine).  The rows
    engine's wave is the coherent form of the same: the camera lanes and
    their bounce-0 shadow lanes, sorted by ray_sort_key (skip_sort False,
    yuki_tpu's default), which the probe itself sends to the rows engine
    (in film order the shadow rows' demand passes the engine's budget of
    24 pairs a row, and the wave would fall back; both are printed).
    Each engine is driven once with the counts at 0, then held to the two
    contracts: skip -2 everywhere is the query
    without skip, bit for bit, and the shadow lanes' .hit is
    any_intersect with the same skip; then each with_skip kernel against
    its plain version on the lanes the dispatch gives it, bit for bit,
    with its time beside the same kernel without skip on the same lanes,
    and bounds from the plain tallies (24 operations a recheck, 40 a
    scaled test)."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_cull as tcu
    from yuki_tpu_torch.ops import trace_rows as trw
    from yuki_tpu_torch.ops import trace_stream as ts
    from yuki_tpu_torch.ops import trace_walker as tw

    data, meta, ch = scene.data, scene.meta, scene.data.chunks
    n = rays[0].shape[0]
    waves = {"bounce-1": _combine(torch, *rays),
             "camera": _combine(torch, *wave0)}
    for w in waves.values():
        check(w[0].shape[0] == 3 * n, f"combined wave of {w[0].shape[0]}")
    for order, w in (("film order", waves["camera"]),
                     ("sorted", _sort_rays(torch, data, *waves["camera"]))):
        words = trw.row_words_interval(ch, *w[:3])
        print(f"the rows engine's probe on the combined camera wave, "
              f"{order}: pair demand {int(traverse._rows_demand(words))} "
              f"against the budget {words.shape[0] * traverse._ROWS_MULT}")
    engines = (("rows", "camera", False), ("slot", "bounce-1", True),
               ("walker", "bounce-1", True), ("fallback", "bounce-1", True))
    names = ("rows_closest_skip", "slot_closest_skip", "walker_closest_skip")
    launches = dict.fromkeys(names, 0)
    for engine, which, skip_sort in engines:
        o, d, t, sk = waves[which]
        q = dict(skip_sort=skip_sort)
        bary = n if skip_sort else None
        with _engine(engine):
            torch.cuda.synchronize()
            reset_all_launches()
            hit = traverse.intersect(data, meta, o, d, t, sk, bary_count=bary,
                                     **q)
            torch.cuda.synchronize()
            counts, c = all_launches(), traverse.counts()
            for k in names:
                launches[k] += counts[k]
            branch = "closest_" + {"fallback": "slot"}.get(engine, engine)
            check(c[branch] == 1 and c["fallbacks"] == (engine == "fallback"),
                  f"combined wave on the {engine} engine: dispatch {c}")
            plain = traverse.intersect(data, meta, o, d, t, **q)
            neutral = traverse.intersect(data, meta, o, d, t,
                                         torch.full_like(sk, -2), **q)
            occ = traverse.any_intersect(data, meta, o[n:], d[n:], t[n:],
                                         sk[n:], **q)
            torch.cuda.synchronize()
            check(_same_hits(torch, neutral, plain), f"combined wave on the "
                  f"{engine} engine: skip -2 differs from no skip")
            n_bad = int((hit.hit[n:] != occ).sum())
            check(n_bad == 0, f"combined wave on the {engine} engine: "
                  f"{n_bad} shadow lanes' hit differs from any_intersect")
            # In natural order no row or bundle mixes closest and shadow
            # lanes, so the closest lanes' answers cannot change.
            check(not skip_sort or (
                torch.equal(hit.prim[:n], plain.prim[:n])
                and torch.equal(hit.t[:n], plain.t[:n])
                and torch.equal(hit.b0[:n], plain.b0[:n])),
                f"combined wave on the {engine} engine: closest lanes "
                "changed")
            reps = 1 if engine == "fallback" else 3
            ms_c = cuda_ms(torch, lambda: traverse.intersect(
                data, meta, o, d, t, sk, bary_count=bary, **q), reps)
            ms_s = cuda_ms(torch, lambda: (
                traverse.intersect(data, meta, o[:n], d[:n], t[:n], **q),
                traverse.any_intersect(data, meta, o[n:], d[n:], t[n:],
                                       sk[n:], **q)), reps)
        print(f"combined {which} wave on the {engine} engine [{3 * n} lanes: "
              f"{n} closest, {2 * n} shadow, {int(occ.sum())} occluded, "
              f"{'skip_sort' if skip_sort else 'sorted'}; "
              f"dispatch {c}]: skip -2 equals no skip bit for bit, shadow "
              f"hit equals any_intersect; combined call {ms_c:.3f} ms, the "
              f"two separate calls {ms_s:.3f} ms; launches "
              f"{ {k: counts[k] for k in names if counts[k]} } [{card}]")
    for k in names:
        check(launches[k] > 0, f"combined waves: {k} never launched")

    result = {}
    k = ch.leaf_size
    # rows_closest_skip on the sorted coherent wave's probe lists.
    o, d, t, sk = _sort_rays(torch, data, *waves["camera"])
    skf = sk.to(torch.float32)
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, o, d, t),
                              traverse._ROWS_C, traverse._ROWS_MULT)
    chunks = int(torch.unique(lists[lists >= 0]).numel())
    kern = (lambda: trw.rows_closest_walk(ch, lists, o, d, t, skf),
            lambda: trw.rows_closest_walk(ch, lists, o, d, t))
    stats = {}
    ref, ms_p = timed_once(torch, lambda: trw.rows_closest_walk_plain(
        ch, lists, o, d, t, stats, skip=skf))
    nbytes_ = o.shape[0] * (32 + 12) + lists.numel() * 4 + chunks * k * 48
    result["rows_closest_skip"] = _skip_kernel(
        torch, "rows_closest_skip", kern, ref, ms_p, nbytes_,
        stats["boxes"] * OPS_SLAB + stats["tests"] * OPS_SCALED,
        f"{3 * n} sorted camera + bounce-0 shadow lanes, {lists.shape[0]} "
        "rows, "
        f"{chunks} chunks listed; {stats['boxes']} rechecks, "
        f"{stats['tests']} triangle tests", card)

    # slot_closest_skip on the bounce-1 wave's slots.
    o, d, t, sk = waves["bounce-1"]
    cl, _ = tcu.candidate_lists_fused(ch, o, d, t, ts.C_MAIN)
    slots = ts._slots(ch, cl, ts.C_MAIN, meta.slot_mult_tight, meta.slot_mult,
                      3 * n)
    check(slots is not None, "slot_closest_skip: the combined wave's slot "
          "budget blew")
    _, slot_ray, row_chunk, valid = slots
    stream = ts._pack_stream(o, d, t, slot_ray, valid, extra=sk)
    kern = (lambda: ts.slot_closest(ch.rows, k, row_chunk, stream, True),
            lambda: ts.slot_closest(ch.rows, k, row_chunk, stream))
    stats = {}
    ref, ms_p = timed_once(torch, lambda: ts.slot_closest_plain(
        ch.rows, k, row_chunk, stream, stats, with_skip=True))
    chunks = int(torch.unique(row_chunk).numel())
    result["slot_closest_skip"] = _skip_kernel(
        torch, "slot_closest_skip", kern, ref, ms_p,
        stream.shape[0] * (32 + 12) + row_chunk.numel() * 4
        + chunks * k * 48, stats["tests"] * OPS_SCALED,
        f"{3 * n} bounce-1 + shadow lanes, {row_chunk.numel()} slot rows, "
        f"{int(valid.sum())} valid slots, {chunks} chunks; {stats['tests']} "
        "triangle tests", card)
    got = ts.slot_closest(ch.rows, k, row_chunk, stream)
    ref = ts.slot_closest_plain(ch.rows, k, row_chunk, stream)
    torch.cuda.synchronize()
    check(torch.equal(got, ref), "slot_closest on the combined wave's slots "
          "differs from its plain version")

    # walker_closest_skip on the bounce-1 wave's bundle lists.
    lists, _ = tw.walker_lists(ts.cross_words(ch, o, d, t), tw.C_WALK)
    skf = sk.to(torch.float32)
    kern = (lambda: tw.walker_closest_walk(ch, lists, o, d, t, skf),
            lambda: tw.walker_closest_walk(ch, lists, o, d, t))
    stats = {}
    ref, ms_p = timed_once(torch, lambda: tw.walker_closest_plain(
        ch, lists, o, d, t, stats, skip=skf))
    chunks = int(torch.unique(lists[lists >= 0]).numel())
    result["walker_closest_skip"] = _skip_kernel(
        torch, "walker_closest_skip", kern, ref, ms_p,
        3 * n * (32 + 8) + lists.numel() * 4 + chunks * k * 48,
        stats["boxes"] * OPS_SLAB + stats["tests"] * OPS_SCALED,
        f"{3 * n} bounce-1 + shadow lanes, {lists.shape[0]} bundles, "
        f"{chunks} chunks listed; {stats['boxes']} rechecks, "
        f"{stats['tests']} triangle tests", card)
    return result, launches


def _skip_kernel(torch, name, kern, ref, ms_p, nbytes_, ops, what, card):
    """A with_skip kernel (kern[0]) against its plain version's output
    ``ref``, bit for bit; its time beside the same kernel without skip on
    the same lanes (kern[1])."""
    got = kern[0]()
    torch.cuda.synchronize()
    pairs = zip(got, ref) if isinstance(got, tuple) else ((got, ref),)
    check(all(torch.equal(g, r) for g, r in pairs),
          f"{name} differs from its plain version")
    ms_k = cuda_ms(torch, kern[0], 10)
    ms_n = cuda_ms(torch, kern[1], 10)
    b_ms, b_by = bound(nbytes_, ops)
    print(f"{name} [{what}]: kernel {ms_k:.4f} ms (without skip on the same "
          f"lanes {ms_n:.4f} ms), plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}): equal bit for bit [{card}]")
    return dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                bound_by=b_by)


def phase_dense_combined(torch, dev, card):
    """12a. Cornell's combined wave through the dense skip sweep: the
    1080p 4096-tile camera wave's 1,048,576 closest lanes (skip -2) and
    their bounce-0 shadow lanes (path_li's own shading), driven once
    through traverse.intersect with the counts at 0; dense_trace_skip
    against its plain version bit for bit; skip -2 against dense_trace,
    the shadow lanes' hits against any_trace; its time beside
    dense_trace's on the same lanes and the two separate sweeps.  Bound:
    dense_ops of the plain version's tally."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace as ttr
    from yuki_tpu_torch.ops.trace import F32_MAX, pack_triangles
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    data, meta = scene.data, scene.meta
    ctx, o, d = _camera_wave(torch, dev, cam, WAVE_TILES)
    n = o.shape[0]
    t_max = torch.full((n,), F32_MAX, device=dev)
    hit = traverse.intersect(data, meta, o, d, t_max, skip_sort=True)
    tables = tsf.make_shade_tables(scene, PathParams(DEPTH))
    out = tsf.shade_fused(tables, hit, o, d, torch.ones_like(o), hit.hit,
                          torch.zeros_like(hit.hit), _ph_i32(ctx), 2, 0)
    co, cd, ct, cs = _combine(torch, o, d, t_max, *out[5:9])
    tris = pack_triangles(data.tris.p0, data.tris.p1, data.tris.p2)
    light = data.tris.area_light
    m, nt = co.shape[0], tris.shape[0]
    torch.cuda.synchronize()
    reset_all_launches()
    hit_c = traverse.intersect(data, meta, co, cd, ct, cs, skip_sort=True,
                               bary_count=n)
    torch.cuda.synchronize()
    launches = {"dense_closest_skip": all_launches()["dense_closest_skip"]}
    check(launches["dense_closest_skip"] == 1,
          f"Cornell combined wave: launches {launches}")
    got = ttr.dense_trace_skip(tris, light, co, cd, ct, cs)
    stats = {}
    ref, ms_p = timed_once(torch, lambda: ttr.dense_trace_skip_plain(
        tris, light, co, cd, ct, cs, stats))
    for g, r, f in zip(got, ref, ("t", "prim", "b0", "b1")):
        check(torch.equal(g, r), f"dense_closest_skip: {f} differs from the "
              "plain version")
    neutral = ttr.dense_trace_skip(tris, light, co, cd, ct,
                                   torch.full_like(cs, -2))
    plain = ttr.dense_trace(tris, co, cd, ct)
    occ = ttr.any_trace(tris, light, co[n:], cd[n:], ct[n:], cs[n:])
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(neutral, plain)),
          "dense_closest_skip: skip -2 differs from dense_trace")
    check(torch.equal(got[1][n:] >= 0, occ),
          "dense_closest_skip: shadow hits differ from any_trace")
    occ_q = traverse.any_intersect(data, meta, co[n:], cd[n:], ct[n:],
                                   cs[n:], skip_sort=True)
    check(torch.equal(hit_c.hit[n:], occ_q), "Cornell combined wave: the "
          "shadow lanes' hit differs from any_intersect")
    ms_k = cuda_ms(torch, lambda: ttr.dense_trace_skip(tris, light, co, cd,
                                                       ct, cs), 10)
    ms_n = cuda_ms(torch, lambda: ttr.dense_trace(tris, co, cd, ct), 10)
    ms_s = cuda_ms(torch, lambda: (
        ttr.dense_trace(tris, co[:n], cd[:n], ct[:n]),
        ttr.any_trace(tris, light, co[n:], cd[n:], ct[n:], cs[n:])), 10)
    tests = stats["tests"]
    b_ms, b_by = bound(m * (28 + 4 + 16) + nt * 52, dense_ops(stats))
    print(f"dense_closest_skip [Cornell combined wave: {m} lanes, {n} "
          f"closest, {m - n} shadow, {int(occ.sum())} occluded, {nt} "
          f"triangles]: kernel {ms_k:.4f} ms (dense_closest on the same "
          f"lanes {ms_n:.4f} ms; the separate closest and occlusion sweeps "
          f"{ms_s:.4f} ms), plain {ms_p:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
          f"{tests} triangle tests): equal bit for bit; skip -2 equals "
          f"dense_trace, shadow hits equal any_trace; launches {launches} "
          f"[{card}]")
    return {"dense_closest_skip": dict(max_abs_err=0.0, ms=ms_k,
                                       plain_ms=ms_p, bound_ms=b_ms,
                                       bound_by=b_by)}, launches


def _sort_rays(torch, data, o, d, *rest):
    from yuki_tpu_torch import traverse

    order = torch.argsort(traverse.ray_sort_key(data, o, d), stable=True)
    return [x[order].contiguous() for x in (o, d, *rest)]


def _pair_waves(torch, data, rays):
    """Phase 13's waves, the bounce-1 rays and their shadow rays each
    sorted by ray_sort_key, and yuki_tpu's pair capacity for each
    (traverse.py:288-297, max(393216, 2 N))."""
    o2, d2, t2, no2, nd2, nt2, sk2 = rays
    waves = {"pairs_closest": _sort_rays(torch, data, o2, d2, t2),
             "pairs_any": _sort_rays(torch, data, no2, nd2, nt2, sk2)}
    return waves, {k: max(393216, 2 * w[0].shape[0])
                   for k, w in waves.items()}


def _pair_slice(torch, tpp, t_max, runs, pt, packed):
    """B1_BLOCKS whole ray blocks a..b-1 from the middle of those with a
    live lane (the sort gathers the parked lanes into blocks of their
    own): (a, b, their runs from 0, their pairs, their packed rows)."""
    nb = runs.shape[0] - 1
    m = t_max.shape[0]
    live = torch.nonzero((t_max > 0.0).reshape(-1)[:nb * tpp.BLOCK]
                         .reshape(nb, -1).any(dim=1) if m == nb * tpp.BLOCK
                         else torch.ones(nb, dtype=torch.bool)).squeeze(1)
    a = min(int(live[live.numel() // 2]), nb - B1_BLOCKS)
    b = a + B1_BLOCKS
    return (a, b, (runs[a:b + 1] - runs[a]).contiguous(),
            pt[int(runs[a]):int(runs[b])].contiguous(),
            packed[a * tpp.BLOCK_ROWS:(b + 1) * tpp.BLOCK_ROWS].contiguous())


def phase_pairs(torch, scene, rays, card):
    """13. The block-pair walks on the wave's bounce-1 rays and their
    shadow rays, each sorted by ray_sort_key, at yuki_tpu's pair capacity
    (traverse.py:288-297, max(393216, 2 N)), driven once with the counts
    at 0; each kernel against its plain version on B1_BLOCKS whole blocks
    from the middle of the list, bit for bit; the whole wave against the
    treelet walk: t bit for bit (both take the direct-t test), prim apart
    from counted ties (equal t), b0/b1 where prim is equal, occlusion
    exact.  Bounds from the plain versions' tallies on the slice (43
    operations a test, 24 a box).  Beside them: the share of the slice's
    pairs the blocks visit, the live lanes a visited pair and the
    contract's floor, the tests the block semantics force (each visited
    pair's live lanes against its real rows; occlusion: up to each lane's
    first occluder and the rows walked) at OPS_DENSE_TEST operations each
    over the card's rate: the least a walk bound to that contract could
    take."""
    from yuki_tpu_torch.ops import trace_pairs as tpp
    from yuki_tpu_torch.ops import trace_treelets as ttt

    data, tl = scene.data, scene.data.treelets
    waves, caps = _pair_waves(torch, data, rays)
    torch.cuda.synchronize()
    tpp.reset_launches()
    out_c = tpp.pairs_closest(tl, *waves["pairs_closest"],
                              max_pairs=caps["pairs_closest"])
    out_a = tpp.pairs_any(tl, *waves["pairs_any"],
                          max_pairs=caps["pairs_any"])
    torch.cuda.synchronize()
    launches = dict(tpp.LAUNCHES)
    check(launches == {"pairs_closest": 1, "pairs_any": 1},
          f"pair walks: launches {launches}")
    result = {}
    row_bytes = tl.leaf_size * 48
    for name, w in waves.items():
        m = w[0].shape[0]
        closest = name == "pairs_closest"
        n_pairs = out_c[4] if closest else out_a[1]
        check(n_pairs <= caps[name], f"{name}: {n_pairs} pairs past the "
              f"capacity {caps[name]}")
        pb, pt, _, nb = tpp.block_candidate_pairs(tl, *w[:3], caps[name])
        runs = tpp.pair_runs(pb, n_pairs, nb)
        packed = tpp._pack_rays(*w[:3], nb, None if closest else w[3])
        walk = tpp.pairs_closest_walk if closest else tpp.pairs_any_walk
        plain = tpp.pairs_closest_plain if closest else tpp.pairs_any_plain
        a, b, s_runs, s_pt, s_packed = _pair_slice(torch, tpp, w[2], runs,
                                                   pt, packed)
        s_n = (b - a) * tpp.BLOCK
        got = walk(tl, s_runs, s_pt, s_packed, s_n)
        stats = {}
        ref, ms_p = timed_once(torch, lambda: plain(tl, s_runs, s_pt,
                                                     s_packed, stats))
        pairs = ((got, ref),) if not closest else zip(got, ref)
        check(all(torch.equal(g, r[:s_n]) for g, r in pairs),
              f"{name} differs from its plain version on blocks {a}-{b - 1}")
        ms_k = cuda_ms(torch, lambda: walk(tl, s_runs, s_pt, s_packed, s_n),
                       10)
        ms_full = cuda_ms(torch, lambda: walk(tl, runs, pt, packed, m), 3)
        ms_call = cuda_ms(torch, lambda: (
            tpp.pairs_closest(tl, *w, max_pairs=caps[name]) if closest else
            tpp.pairs_any(tl, *w, max_pairs=caps[name])), 3)
        b_ms, b_by = bound(s_n * (28 + (16 if closest else 5))
                           + s_pt.numel() * 4 + stats["treelets"] * row_bytes,
                           stats["tests"] * OPS_WATERTIGHT
                           + stats["boxes"] * OPS_SLAB)
        if closest:
            t_w, p_w, b0_w, b1_w = ttt.treelet_closest(tl, *w)
            t_p, p_p, b0_p, b1_p = out_c[:4]
            n_t = int((t_p != t_w).sum())
            same = p_p == p_w
            ties = int((~same).sum())
            n_b = int(((b0_p != b0_w) | (b1_p != b1_w))[same].sum())
            found = (f"{int((p_p >= 0).sum())} hits; against the treelet "
                     f"walk: t differs on {n_t} rays, prim on {ties} ties, "
                     f"b0/b1 on {n_b} rays where prim is equal")
            check(n_t == 0 and n_b == 0, f"{name} against the treelet walk: "
                  f"{found}")
        else:
            occ_w = ttt.treelet_any(tl, *w)
            n_o = int((out_a[0] != occ_w).sum())
            found = (f"{int(out_a[0].sum())} occluded; against the treelet "
                     f"walk: {n_o} verdicts differ")
            check(n_o == 0, f"{name} against the treelet walk: {found}")
        floor_ms = stats["forced"] * OPS_DENSE_TEST / PEAK_OPS * 1e3
        print(f"{name} [{m} sorted {'bounce-1' if closest else 'shadow'} "
              f"rays, {nb} blocks, {n_pairs} pairs (capacity {caps[name]}), "
              f"{found}]: whole wave: kernel {ms_full:.4f} ms, call with the "
              f"cull {ms_call:.4f} ms; blocks {a}-{b - 1} ({s_n} rays, "
              f"{s_pt.numel()} pairs, {stats['visited']} visited ("
              f"{stats['visited'] / max(1, stats['pairs']):.4f}), live lanes "
              f"a visited pair {stats['live'] / max(1, stats['visited']):.1f}"
              f"): kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}; {stats['tests']} triangle tests, "
              f"{stats['boxes']} box tests, {stats['treelets']} treelets), "
              f"contract's floor {floor_ms:.4f} ms ({stats['forced']} forced "
              f"tests): equal bit for bit [{card}]")
        result[name] = dict(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                            bound_ms=b_ms, bound_by=b_by, wave_ms=ms_full)
    return result, launches


def phase_sort(torch, scene, rays, card):
    """13a. The coherence sort on the card: ray_sort_key against the same
    function on the CPU (held there against yuki_tpu's u32 key), the
    _sorted_call round trip, the sort's cost per call at 524,288 and
    1,572,864 rays, and the dispatch with skip_sort False (sorted) against
    True on the bounce-1 rays and their shadow rays: prim and occlusion
    equal apart from counted ties (t within an ulp), with the branch
    counts and the time of each."""
    from yuki_tpu_torch import traverse

    data, meta = scene.data, scene.meta
    o2, d2, t2, no2, nd2, nt2, sk2 = rays
    key = traverse.ray_sort_key(data, o2, d2)
    bounds = SimpleNamespace(world_lo=data.world_lo.cpu(),
                             world_hi=data.world_hi.cpu())
    check(torch.equal(key.cpu(), traverse.ray_sort_key(bounds, o2.cpu(),
                                                       d2.cpu())),
          "ray_sort_key on the card differs from the CPU's")
    idx = torch.arange(o2.shape[0], device=o2.device)
    back = traverse._sorted_call(data, o2, d2, t2, idx,
                                 lambda o, d, t, e: (e,))[0]
    check(torch.equal(back, idx), "_sorted_call does not restore the order")
    costs = []
    comb = _combine(torch, o2, d2, t2, no2, nd2, nt2, sk2)
    for w in ((o2, d2, t2, None), comb):
        ms = cuda_ms(torch, lambda: traverse._sorted_call(
            data, *w, lambda o, d, t, e: (t,)), 5)
        costs.append(f"{w[0].shape[0]} rays {ms:.3f} ms")
    out = {}
    for skip_sort in (False, True):
        traverse.reset_counts()
        hit = traverse.intersect(data, meta, o2, d2, t2, skip_sort=skip_sort)
        c1 = traverse.counts()
        traverse.reset_counts()
        occ = traverse.any_intersect(data, meta, no2, nd2, nt2, sk2,
                                     skip_sort=skip_sort)
        c2 = traverse.counts()
        ms_c = cuda_ms(torch, lambda: traverse.intersect(
            data, meta, o2, d2, t2, skip_sort=skip_sort), 3)
        ms_a = cuda_ms(torch, lambda: traverse.any_intersect(
            data, meta, no2, nd2, nt2, sk2, skip_sort=skip_sort), 3)
        out[skip_sort] = hit, occ, c1, c2, ms_c, ms_a
    (h_s, occ_s, c1_s, c2_s, ms_cs, ms_as) = out[False]
    (h_n, occ_n, c1_n, c2_n, ms_cn, ms_an) = out[True]
    ulp = (h_s.t.view(torch.int32) - h_n.t.view(torch.int32)).abs()
    same = h_s.prim == h_n.prim
    ties = int((~same).sum())
    check(int((ulp[~same] > 1).sum()) == 0,
          "sorted dispatch: prim differs where t is not within an ulp")
    max_ulp = int(ulp.max())
    check(max_ulp <= 1, f"sorted dispatch: t {max_ulp} ulps apart")
    n_occ = int((occ_s != occ_n).sum())
    check(n_occ == 0, f"sorted dispatch: {n_occ} occlusion verdicts differ")

    def branches(c):
        return {k: v for k, v in c.items() if v and k != "host_syncs"}

    print(f"coherence sort [{card}]: ray_sort_key equals the CPU's on "
          f"{o2.shape[0]} rays, _sorted_call restores the order; cost per "
          f"call (key, stable argsort, gathers, one scatter back): "
          f"{', '.join(costs)}; dispatch sorted against skip_sort on "
          f"{o2.shape[0]} bounce-1 rays: prim differs at {ties} ties, t at "
          f"most {max_ulp} ulp apart, {c1_s['overflow_rays']} / "
          f"{c1_n['overflow_rays']} overflow rays, branches "
          f"{branches(c1_s)} / {branches(c1_n)}, {ms_cs:.3f} / {ms_cn:.3f} "
          f"ms a call; {no2.shape[0]} shadow rays: occlusion equal, "
          f"branches {branches(c2_s)} / {branches(c2_n)}, {ms_as:.3f} / "
          f"{ms_an:.3f} ms a call")


def run_renderer(torch, scene, cam, film, sampler, params, fs, rs,
                 seed=1, timeout=600.0):
    """Drive a Renderer to its RenderFinished message, polling as the
    headless app does; returns it.  A RenderError fails the check."""
    from yuki_tpu_torch.renderer import RenderError, Renderer, RenderFinished

    r = Renderer()
    r.launch(scene, cam, film, sampler, params, fs, rs, match_seed=seed)
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < timeout:
            time.sleep(0.02)
            active = r.is_active()
            for msg in r.check_status():
                check(not isinstance(msg, RenderError),
                      f"renderer: {getattr(msg, 'message', '')}")
                if isinstance(msg, RenderFinished):
                    return msg
            check(active, "renderer: thread ended without finishing")
        raise SmokeFailure(f"renderer: no RenderFinished in {timeout} s")
    finally:
        r.kill()


def phase_loaders(torch, np, dev, card):
    """Phase 14's scene files through the Renderer, and the small atrium
    against its golden."""
    from yuki_tpu_torch.app.settings import SceneLoadSettings
    from yuki_tpu_torch.app.util import try_load_scene
    from yuki_tpu_torch.film import FilmSettings, film_or_new
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import RenderSettings, render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.atrium import load_atrium

    for name in ("cornell.pbrt", "example.xml", "plane.ply"):
        scene, cam, fs, secs = try_load_scene(
            SceneLoadSettings(path=os.path.join(REPO, "scenes", name)),
            device=dev)
        check(scene.device.type == "cuda", f"{name}: scene on {scene.device}")
        film = film_or_new(None, fs, device=dev)
        torch.cuda.synchronize()
        reset_all_launches()
        done = run_renderer(torch, scene, cam, film, UniformSampler(1),
                            PathParams(5), fs, RenderSettings())
        torch.cuda.synchronize()
        counts = {k: v for k, v in all_launches().items() if v}
        img = film.image()
        check(img.shape == (fs.res[1], fs.res[0], 3),
              f"{name}: shape {img.shape}")
        check(np.isfinite(img).all() and float(img.mean()) > 0.0,
              f"{name}: non-finite or black image")
        check(set(counts) == {"raygen_trace", "bounce"},
              f"{name}: launches {counts}, not the wave's two kernels")
        print(f"loader {name} on the card: load {secs:.3f} s, "
              f"{scene.meta.n_tris} triangles, {scene.meta.n_spheres} "
              f"spheres, {fs.res[0]}x{fs.res[1]} d5 1spp through Renderer: "
              f"{done.ray_count} closest-hit rays in {done.elapsed_s:.3f} s, "
              f"launches {counts}, image mean {float(img.mean()):.5f} "
              f"[{card}]")

    scene, cam, _ = load_atrium(device=dev, small=True)
    check(scene.meta.n_tris == 1024, f"small atrium: {scene.meta.n_tris}")
    reset_all_launches()
    res = render_frame(scene, cam, FilmSettings(res=(64, 48), tile_dim=16),
                       UniformSampler(1), PathParams(3), wave_tiles=12,
                       seed=1)
    torch.cuda.synchronize()
    check(all_launches()["bounce"] > 0, "small atrium: bounce not launched")
    img = res.film.image()
    gold = np.load(ATRIUM_GOLDEN)["img"]
    check(img.shape == gold.shape and np.isfinite(img).all(),
          f"small atrium golden: shape {img.shape} or non-finite pixels")
    n_bad, limit, mean_rel = deep_parity(np, gold, img)
    print(f"golden small atrium 64x48 d3 1spp seed 1 through the fused "
          f"wave: divergent px {n_bad} (limit {limit}), mean rel diff "
          f"{mean_rel:.3g}")


def phase_atrium(torch, np, dev, card):
    """Phase 14's full atrium: generation, load and build times, then the
    1080p d5 1 spp frame (three timed, one profiled)."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.ops import trace as tdense
    from yuki_tpu_torch.ops import trace_pairs as tpp
    from yuki_tpu_torch.ops import trace_walker as tw
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene import atrium

    t0 = time.monotonic()
    counts = atrium.write_scene(atrium.atrium_dir())
    t_gen = time.monotonic() - t0
    t0 = time.monotonic()
    scene, cam, fs = atrium.load_atrium(device=dev)
    t_load = time.monotonic() - t0
    sec, meta = scene.build_seconds, scene.meta
    check(meta.n_tris == counts["total"] == 347136,
          f"atrium: {meta.n_tris} triangles, files {counts}")
    check(meta.traversal == "treelet", f"atrium: traversal {meta.traversal}")
    t_build = sum(sec.values())
    tl = scene.data.treelets
    print(f"atrium host load: generation {t_gen:.3f} s, load {t_load:.3f} s "
          f"= parse and tables {t_load - t_build:.3f} s + BVH "
          f"{sec['bvh']:.3f} s + treelets {sec['treelets']:.3f} s + chunks "
          f"{sec['chunks']:.3f} s + slot budgets {sec['slot_mult']:.3f} s; "
          f"n_tris {meta.n_tris}, n_spheres {meta.n_spheres}, n_treelets "
          f"{tl.n_treelets}, n_supers {tl.n_supers}, chunks "
          f"{scene.data.chunks.n_treelets}, slot_mult "
          f"{meta.slot_mult_tight}/{meta.slot_mult}, film {fs.res}")

    traverse.reset_counts()
    reset_all_launches()
    res = render_frame(scene, cam, FilmSettings(res=(64, 48), tile_dim=16),
                       UniformSampler(1), PathParams(3), wave_tiles=12,
                       seed=1)
    torch.cuda.synchronize()
    c, launches = traverse.counts(), all_launches()
    check(launches["shade"] > 0 and launches["resolve"] > 0,
          f"full atrium golden: launches {launches}")
    img = res.film.image()
    gold = np.load(ATRIUM_FULL_GOLDEN)["img"]
    check(img.shape == gold.shape and np.isfinite(img).all(),
          f"full atrium golden: shape {img.shape} or non-finite pixels")
    n_bad, limit, mean_rel = deep_parity(np, gold, img)
    print(f"golden full atrium 64x48 d3 1spp seed 1 through the treelet "
          f"dispatch: divergent px {n_bad} (limit {limit}), mean rel diff "
          f"{mean_rel:.3g}; dispatch {c}")

    film_settings = FilmSettings(res=RES, tile_dim=16)

    def frame():
        return render_frame(scene, cam, film_settings, UniformSampler(1),
                            PathParams(max_depth=DEPTH),
                            wave_tiles=COL_WAVE_TILES, seed=1)

    walls, rays = [], None
    for i in range(3):
        torch.cuda.synchronize()
        reset_all_launches()
        res = frame()
        torch.cuda.synchronize()
        walls.append(res.elapsed_s)
        if i == 0:
            launches = {k: v for k, v in all_launches().items() if v}
            branches = traverse.counts()
            rays = res.ray_count
            img = res.film.image()
        check(res.ray_count == rays, f"atrium: ray count {res.ray_count} "
              f"against {rays}")
    check(img.shape == (RES[1], RES[0], 3), f"atrium frame: {img.shape}")
    check(np.isfinite(img).all() and float(img.mean()) > 0.0,
          "atrium frame: non-finite or black image")
    for name in ("shade", "resolve", "cull", "cross_words", "slot_closest",
                 "slot_any", "rows_closest", "rows_any"):
        check(launches.get(name, 0) > 0, f"atrium frame: {name} never "
              "launched")
    off = (*tpf.LAUNCHES, *tdense.LAUNCHES, *tw.LAUNCHES, *tpp.LAUNCHES)
    check(not any(launches.get(k, 0) for k in off),
          f"atrium frame: a kernel off its path launched ({launches})")
    walks = launches.get("treelet_closest", 0) + launches.get("treelet_any",
                                                              0)
    check(walks == branches["fallbacks"], f"atrium frame: {walks} treelet "
          f"walks for {branches['fallbacks']} fallbacks")
    med = sorted(walls)[1]
    print(f"atrium frame {RES[0]}x{RES[1]} d{DEPTH} 1spp {COL_WAVE_TILES}-"
          f"tile waves seed 1: wall {med:.3f} s (median of "
          f"{', '.join(f'{w:.3f}' for w in walls)}), {rays} closest-hit "
          f"rays = {rays / med / 1e6:.2f} Mrays/s, launches {launches}, "
          f"dispatch {branches}, image mean {float(img.mean()):.5f} [{card}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        frame()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups, top_ops = device_breakdown(torch, prof)
    busy = sum(v[0] for v in groups.values())
    if busy > 0.0:
        parts = ", ".join(f"{k} {ms:.3f} ms / {cnt} kernels"
                          for k, (ms, cnt) in groups.items() if cnt)
        print(f"atrium frame under torch.profiler: wall {wall * 1e3:.3f} ms,"
              f" device busy {busy:.3f} ms, idle share "
              f"{100 * (1 - busy / wall / 1e3):.1f}% of this frame, "
              f"{100 * (1 - busy / med / 1e3):.1f}% of the median unprofiled "
              f"frame: {parts} [{card}]")
        print("atrium torch operators by device time: " + "; ".join(
            f"{name} {ms:.3f} ms / {cnt} calls" for ms, cnt, name in top_ops))
    else:
        print("atrium frame under torch.profiler: no device time recorded "
              "(busy time and idle share not measured)")


def phase_headless(torch, np, dev, card):
    """Phase 15: the CLI as a subprocess against an in-process Renderer
    film of the same settings."""
    import tempfile

    from yuki_tpu_torch.app.exr import read_exr
    from yuki_tpu_torch.app.settings import (InitialSettings,
                                             SceneLoadSettings, save_settings)
    from yuki_tpu_torch.app.util import try_load_scene
    from yuki_tpu_torch.film import FilmSettings, film_or_new
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import RenderSettings
    from yuki_tpu_torch.sampling import StratifiedSampler
    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    scene_file = os.path.join(REPO, "scenes", "cornell.pbrt")
    s = InitialSettings(
        film_settings=FilmSettings(res=(640, 480), tile_dim=16),
        sampler=StratifiedSampler(2, 2), integrator=PathParams(DEPTH),
        render_settings=RenderSettings(wave_tiles=256))
    with tempfile.TemporaryDirectory() as tmp:
        save_settings(s, os.path.join(tmp, "s.yaml"))
        out = os.path.join(tmp, "out.exr")
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "yuki_tpu_torch", f"--scene={scene_file}",
             f"--settings={os.path.join(tmp, 's.yaml')}", f"--out={out}",
             f"--profile={trace_dir}"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600)
        wall = time.monotonic() - t0
        check(proc.returncode == 0, f"headless: exit {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        got = read_exr(out)
        traces = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        text = "".join(open(f).read() for f in traces)
    for name in ("path_fused.raygen_trace", "path_fused.bounces"):
        check(name in text, f"headless: the trace does not name {name}")
    scene, cam, _, _ = try_load_scene(SceneLoadSettings(path=scene_file),
                                      device=dev)
    film = film_or_new(None, s.film_settings, device=dev)
    torch.cuda.synchronize()
    reset_all_launches()
    run_renderer(torch, scene, cam, film, s.sampler, s.integrator,
                 s.film_settings, s.render_settings, seed=0)
    torch.cuda.synchronize()
    counts = {k: v for k, v in all_launches().items() if v}
    check(set(counts) == {"raygen_trace", "bounce"},
          f"headless: in-process launches {counts}")
    ref = filmic(film.image_device(), FilmicParams()).cpu().numpy()
    check(got.shape == ref.shape and np.array_equal(
        got.view(np.uint32), ref.view(np.uint32)),
        "headless: the EXR differs from the in-process render")
    check(float(ref.mean()) > 0.0, "headless: black image")
    print(f"headless python -m yuki_tpu_torch cornell.pbrt 640x480 d{DEPTH} "
          f"StratifiedSampler(2, 2) Filmic --profile: exit 0 in {wall:.3f} s"
          f" wall (process start, kernel library load, scene load, render, "
          f"trace export), EXR equal to the in-process film bit for bit, "
          f"trace {len(text)} bytes [{card}]")


def _frames(torch, fn, n=3):
    """n calls of fn (a frame), each from launch counts at 0: (results,
    wall seconds, the first call's launches, dispatch counts and Whitted
    steps)."""
    from yuki_tpu_torch import integrators as tintg
    from yuki_tpu_torch import traverse

    out, walls = [], []
    for i in range(n):
        torch.cuda.synchronize()
        reset_all_launches()
        tintg.reset_counts()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        walls.append(time.monotonic() - t0)
        if i == 0:
            launches = {k: v for k, v in all_launches().items() if v}
            counts = {**traverse.counts(), **tintg.COUNTS}
        out.append(res)
    return out, walls, launches, counts


def _walls(walls):
    med = sorted(walls)[len(walls) // 2]
    return med, ", ".join(f"{w:.3f}" for w in walls)


def phase_whitted(torch, np, dev, card, col_scene, col_cam):
    """Phase 16's Whitted: Cornell's 64x48 render against its golden and
    the colonnade's against the treelet golden, then the 1080p frames of
    both (median of three)."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import WhittedParams
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    for name, sc, cm, gold, spp, seed in (
            ("cornell", scene, cam, WHITTED_GOLDEN, 2, 42),
            ("colonnade", col_scene, col_cam, COL_WHITTED_GOLDEN, 1, 1)):
        res = render_frame(sc, cm, FilmSettings(res=(64, 48), tile_dim=16),
                           UniformSampler(spp), WhittedParams(3),
                           wave_tiles=12, seed=seed)
        img = res.film.image()
        ref = np.load(gold)["img"]
        check(img.shape == ref.shape and np.isfinite(img).all(),
              f"whitted golden {name}: shape {img.shape} or non-finite")
        n_bad, limit, mean_rel = deep_parity(np, ref, img, spp)
        print(f"golden {name} 64x48 Whitted(3) {spp}spp seed {seed} on the "
              f"card: divergent px {n_bad} (limit {limit}), mean rel diff "
              f"{mean_rel:.3g}")

    fs = FilmSettings(res=RES, tile_dim=16)
    for name, sc, cm, wave in (("cornell", scene, cam, WAVE_TILES),
                               ("colonnade", col_scene, col_cam,
                                COL_WAVE_TILES)):
        frames, walls, launches, counts = _frames(torch, lambda: render_frame(
            sc, cm, fs, UniformSampler(1), WhittedParams(3), wave_tiles=wave,
            seed=1))
        img = frames[0].film.image()
        rays = frames[0].ray_count
        check(all(f.ray_count == rays for f in frames),
              f"whitted {name}: ray counts differ between frames")
        check(img.shape == (RES[1], RES[0], 3) and np.isfinite(img).all()
              and float(img.mean()) > 0.0,
              f"whitted {name}: non-finite or black frame")
        if name == "cornell":
            ok = {"dense_closest", "dense_any"} <= set(launches)
        else:  # coherent camera waves; shadow rays on either engine
            ok = "rows_closest" in launches and bool(
                {"rows_any", "slot_any"} & set(launches))
        check(ok, f"whitted {name}: launches {launches}")
        med, all_w = _walls(walls)
        print(f"whitted {name} {RES[0]}x{RES[1]} Whitted(3) 1spp {wave}-tile "
              f"waves seed 1: wall {med:.3f} s (median of {all_w}), {rays} "
              f"closest-hit rays = {rays / med / 1e6:.2f} Mrays/s, "
              f"{counts['whitted_steps']} tree steps, "
              f"{counts['host_syncs']} host reads, launches {launches}, "
              f"dispatch {counts}, image mean {float(img.mean()):.5f} [{card}]")


def whitted_bytes(n, n_lights):
    """(shade, resolve) bytes of a Whitted step over n lanes, each lane
    counted as if it read and wrote all it may (tables left out: they stay
    in cache).  Shade reads the ray (24), carry (scale 12, depth 4, spec,
    active), t_max, the triangles' hit (16), the ray count and 8 B of
    draws a light; writes the count, 40 B a light (shadow ray, t_max,
    contribution), the emission (12), two children (72) and the flags.
    Resolve reads the flags, 41 B a light (t_max, verdict, ray for the
    sphere test, contribution), the emission, carry and radiance, both
    children and a stack entry (37); writes the radiance, a stack entry,
    the next ray and carry (47), t_max, sp and the pending flag."""
    shade = n * ((24 + 12 + 4 + 1 + 1 + 4 + 16 + 4 + 8 * n_lights)
                 + (4 + 40 * n_lights + 12 + 72 + 1))
    resolve = n * ((1 + 41 * n_lights + 12 + 12 + 4 + 4 + 12 + 72 + 37)
                   + (12 + 37 + 47 + 4 + 4 + 1))
    return shade, resolve


def phase_whitted_kernels(torch, np, dev, card):
    """Whitted's shade and resolve kernels on a wave of Cornell's 1080p
    film (WAVE_TILES tiles, StratifiedSampler(1, 1), Whitted(3)): step 0
    against the plain twins bit for bit, each kernel timed with CUDA events
    against its bytes bound, its registers and spills; then the 1080p
    frame by the kernels against the chain (its route on CPU lanes, forced
    by integrators._card_lanes), bit for bit, with both walls and the
    kernels' launches."""
    import dataclasses

    from yuki_tpu_torch import integrators as tintg
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import WhittedParams
    from yuki_tpu_torch.ops import whitted_fused as wf
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import SampleCtx, StratifiedSampler
    from yuki_tpu_torch.scene.cornell import cornell

    _, px, py = _cornell_wave(torch, dev)
    scene, cam, _ = cornell(device=dev)
    data, meta = scene.data, scene.meta
    sam = StratifiedSampler(1, 1)
    ctx = SampleCtx(px=px, py=py, sample_index=0, seed=2 ** 31 + 5)
    u = sam.get_2d(ctx, 0)
    o, d = Camera.create(cam, *RES).ray(
        torch.stack([px.float(), py.float()], -1) + u)
    n, n_lights = px.shape[0], len(meta.light_types)
    tb = wf.make_whitted_tables(scene, WhittedParams(3), n)

    def fresh():
        return wf.init_state(tb, o.contiguous(), d.contiguous())

    def copy(st):
        return dataclasses.replace(st, **{
            f.name: ({k: v.clone() for k, v in st.stack.items()}
                     if f.name == "stack" else getattr(st, f.name).clone())
            for f in dataclasses.fields(st)})

    def same(a, b):
        if a.dtype == torch.float32:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)

    st = fresh()
    draws = wf.step_draws(sam, ctx, 2, n_lights)
    tri = traverse.closest_triangles(data, meta, st.o, st.d, st.t_max)
    st_p = copy(st)
    so = wf.whitted_shade(tb, st, tri, 2, draws)
    so_p = wf.whitted_shade_plain(tb, st_p, tri, 2, draws)
    for f in wf.ShadeOut._fields:
        check(same(getattr(so, f), getattr(so_p, f)),
              f"whitted_shade: {f} differs from the plain twin's")
    occ = traverse.any_triangles(data, meta, so.no, so.nd, so.nt, tb.skip)
    st_r, st_rp = copy(st), copy(st)
    wf.whitted_resolve(tb, st_r, so, occ)
    wf.whitted_resolve_plain(tb, st_rp, so, occ)
    for f in dataclasses.fields(st_r):
        if f.name == "stack":
            ok = all(same(st_r.stack[k], st_rp.stack[k]) for k in st_r.stack)
        else:
            ok = same(getattr(st_r, f.name), getattr(st_rp, f.name))
        check(ok, f"whitted_resolve: {f.name} differs from the plain twin's")

    b_shade, b_resolve = whitted_bytes(n, n_lights)
    ms_s = cuda_ms(torch, lambda: wf.whitted_shade(tb, st, tri, 2, draws), 20)
    ms_sp = cuda_ms(torch, lambda: wf.whitted_shade_plain(
        tb, copy(st), tri, 2, draws), 3)
    ms_r = cuda_ms(torch, lambda: wf.whitted_resolve(tb, copy(st), so, occ),
                   20)
    ms_copy = cuda_ms(torch, lambda: copy(st), 20)
    ms_rp = cuda_ms(torch, lambda: wf.whitted_resolve_plain(
        tb, copy(st), so, occ), 3)
    ms_r, ms_rp = ms_r - ms_copy, ms_rp - ms_copy
    result = {}
    for name, ms, ms_p, nb in (("whitted_shade", ms_s, ms_sp, b_shade),
                               ("whitted_resolve", ms_r, ms_rp, b_resolve)):
        b_ms = nb / PEAK_BYTES * 1e3
        result[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=ms_p,
                            bound_ms=b_ms, bound_by="bytes")
        print(f"{name} [{n} lanes, Cornell step 0, {sampler_name(sam)}]: "
              f"kernel {ms:.4f} ms, plain {ms_p:.4f} ms, bound {b_ms:.4f} ms "
              f"(bytes; {nb / n:.0f} B a lane); every output equal to the "
              f"twin's; {ptxas_usage(name + '_kernel')} [{card}]")
    print(f"  (resolve timed on a copy of the state each call: "
          f"{ms_copy:.4f} ms of copying taken off)")

    fs = FilmSettings(res=RES, tile_dim=16)
    out = {}
    card_lanes = tintg._card_lanes
    try:
        for kernels in (False, True):
            tintg._card_lanes = lambda o: kernels
            out[kernels] = _frames(torch, lambda: render_frame(
                scene, cam, fs, sam, WhittedParams(3),
                wave_tiles=WAVE_TILES, seed=7))
    finally:
        tintg._card_lanes = card_lanes
    chain, fused = out[False], out[True]
    img_c, img_f = chain[0][0].film.image(), fused[0][0].film.image()
    check(img_c.tobytes() == img_f.tobytes()
          and chain[0][0].ray_count == fused[0][0].ray_count,
          "whitted frame: the kernels' image or rays differ from the chain's")
    check(fused[3]["whitted_fused_steps"] == fused[3]["whitted_steps"] > 2
          and chain[3]["whitted_fused_steps"] == 0,
          f"whitted frame: steps {fused[3]} / {chain[3]}")
    launches = {k: fused[2].get(k, 0) for k in ("whitted_shade",
                                                "whitted_resolve")}
    (med_c, all_c), (med_f, all_f) = _walls(chain[1]), _walls(fused[1])
    rays = fused[0][0].ray_count
    print(f"whitted frame cornell {RES[0]}x{RES[1]} Whitted(3) "
          f"{sampler_name(sam)} {WAVE_TILES}-tile waves: chain {med_c:.3f} s "
          f"(median of {all_c}), kernels {med_f:.3f} s (median of {all_f}) "
          f"= {rays / med_f / 1e6:.2f} Mrays/s; image and {rays} rays equal; "
          f"{fused[3]['whitted_steps']} steps; launches {fused[2]} [{card}]")
    return result, launches


def phase_path_chain(torch, np, dev, card):
    """Phase 16's path chain: the 1080p Cornell frame at depth 5, 1 spp,
    through path_li with the fused wave off, by the shading chain against
    the shade kernels' route (median of three each)."""
    from yuki_tpu_torch import integrators as tintg
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)
    out = {}
    tpf.PATH_FUSED_MODE = "off"
    try:
        for mode in ("off", "auto"):
            tintg.FUSED_SHADE_MODE = mode
            out[mode] = _frames(torch, lambda: render_frame(
                scene, cam, fs, UniformSampler(1), PathParams(DEPTH),
                wave_tiles=WAVE_TILES, seed=1))
    finally:
        tpf.PATH_FUSED_MODE = "auto"
        tintg.FUSED_SHADE_MODE = "auto"
    chain, fused = out["off"], out["auto"]
    check(not {"shade", "resolve"} & set(chain[2]),
          f"path chain: the shade kernels launched ({chain[2]})")
    check({"shade", "resolve"} <= set(fused[2]),
          f"path fused route: launches {fused[2]}")
    got, ref = chain[0][0].film.image(), fused[0][0].film.image()
    rays_c, rays_f = chain[0][0].ray_count, fused[0][0].ray_count
    check(np.isfinite(got).all() and float(got.mean()) > 0.0,
          "path chain: non-finite or black frame")
    check(abs(rays_c - rays_f) <= max(16, 0.01 * rays_f),
          f"path chain: rays {rays_c} vs the fused route's {rays_f}")
    n_bad, limit, mean_rel = deep_parity(np, ref, got)
    (med_c, all_c), (med_f, all_f) = _walls(chain[1]), _walls(fused[1])
    print(f"path chain cornell {RES[0]}x{RES[1]} d{DEPTH} 1spp "
          f"{WAVE_TILES}-tile waves through path_li: chain {med_c:.3f} s "
          f"(median of {all_c}), {rays_c} closest-hit rays, launches "
          f"{chain[2]}, {chain[3]['host_syncs']} host reads; shade kernels "
          f"{med_f:.3f} s (median of {all_f}), {rays_f} rays, launches "
          f"{fused[2]}; chain against the kernels: divergent px {n_bad} "
          f"(limit {limit}), mean rel diff {mean_rel:.3g} [{card}]")


def phase_debug_views(torch, np, dev, card, col_scene, col_cam):
    """Phase 16's debug views: each of the four at 1080p on Cornell and on
    the colonnade (one frame each, the BVH walk's steps and host reads
    beside BVHIntersections), then the card's 64x48 BVHIntersections
    film against the CPU's, bit for bit."""
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import DEBUG_VIEWS
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam, _ = cornell(device=dev)
    fs = FilmSettings(res=RES, tile_dim=16)
    for name, sc, cm, wave in (("cornell", scene, cam, WAVE_TILES),
                               ("colonnade", col_scene, col_cam,
                                COL_WAVE_TILES)):
        parts = []
        for view in DEBUG_VIEWS:
            frames, walls, launches, counts = _frames(
                torch, lambda: render_frame(sc, cm, fs, UniformSampler(1),
                                            view, wave_tiles=wave, seed=1),
                n=1)
            img = frames[0].film.image()
            check(np.isfinite(img).all() and float(img.max()) > 0.0,
                  f"{view} {name}: non-finite or black frame")
            part = f"{view} {walls[0]:.3f} s"
            if view == "bvh_intersections":
                check(counts["bvh_walks"] > 0 and not launches,
                      f"{view} {name}: walks {counts['bvh_walks']}, "
                      f"launches {launches}")
                part += (f" ({counts['bvh_walks']} walks, "
                         f"{counts['bvh_steps']} steps = host reads, "
                         f"{int(img[..., 0].max())} steps at most a ray, "
                         f"{float(img[..., 0].mean()):.2f} a ray)")
            else:
                part += f" (launches {launches})"
            parts.append(part)
        print(f"debug views {name} {RES[0]}x{RES[1]} 1spp {wave}-tile waves,"
              f" one frame each (first call): {'; '.join(parts)} [{card}]")
    cpu_scene, cpu_cam, _ = cornell(device="cpu")
    films = [render_frame(sc, cm, FilmSettings(res=(64, 48), tile_dim=16),
                          UniformSampler(1), "bvh_intersections",
                          wave_tiles=12, seed=1).film.image()
             for sc, cm in ((scene, cam), (cpu_scene, cpu_cam))]
    check(np.array_equal(films[0].view(np.uint32), films[1].view(np.uint32)),
          "bvh_intersections: the card's 64x48 film differs from the CPU's")
    print("bvh_intersections cornell 64x48: the card's film equals the "
          "CPU's bit for bit")


def phase_headless_defaults(torch, np, dev, card):
    """Phase 15's second CLI run, with no settings file: InitialSettings
    (Cornell, Whitted(3), StratifiedSampler(1, 1), 640x480, Filmic)
    against the in-process render, bit for bit."""
    import tempfile

    from yuki_tpu_torch.app.exr import read_exr
    from yuki_tpu_torch.app.settings import InitialSettings
    from yuki_tpu_torch.app.util import try_load_scene
    from yuki_tpu_torch.film import film_or_new
    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    s = InitialSettings()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "x.exr")
        t0 = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "yuki_tpu_torch", f"--out={out}"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600)
        wall = time.monotonic() - t0
        check(proc.returncode == 0, f"headless defaults: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        got = read_exr(out)
    scene, cam, _, _ = try_load_scene(s.load_settings, device=dev)
    film = film_or_new(None, s.film_settings, device=dev)
    torch.cuda.synchronize()
    reset_all_launches()
    run_renderer(torch, scene, cam, film, s.sampler, s.integrator,
                 s.film_settings, s.render_settings, seed=0)
    torch.cuda.synchronize()
    counts = {k: v for k, v in all_launches().items() if v}
    check({"dense_closest", "dense_any"} <= set(counts),
          f"headless defaults: in-process launches {counts}")
    ref = filmic(film.image_device(), FilmicParams()).cpu().numpy()
    check(got.shape == ref.shape and np.array_equal(
        got.view(np.uint32), ref.view(np.uint32)),
        "headless defaults: the EXR differs from the in-process render")
    check(float(ref.mean()) > 0.0, "headless defaults: black image")
    print(f"headless python -m yuki_tpu_torch with no settings file "
          f"(Whitted(3), StratifiedSampler(1, 1), 640x480, Filmic): exit 0 "
          f"in {wall:.3f} s wall, EXR equal to the in-process render bit "
          f"for bit, in-process launches {counts} [{card}]")


def _http(method, url, body=None, timeout=120.0):
    """(status, bytes) of one request with its own timeout."""
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


def decode_png(np, png):
    """[H,W,3] uint8 of an 8-bit RGB PNG whose rows all use filter 0 (the
    viewer's encoder), by zlib."""
    import struct
    import zlib

    check(png[:8] == b"\x89PNG\r\n\x1a\n", "png: bad signature")
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(png):
        n, = struct.unpack(">I", png[pos:pos + 4])
        kind, data = png[pos + 4:pos + 8], png[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", data[:10])
            check((depth, ctype) == (8, 2), f"png: depth {depth} type {ctype}")
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not raw[:, 0].any(), "png: a row filter is not 0")
    return raw[:, 1:].reshape(h, w, 3)


def _wait_done(base, deadline_s):
    """Poll /status until the render is done; fails on an error line or
    at the deadline.  Returns the status text and the seconds waited."""
    t0 = time.monotonic()
    text = ""
    while time.monotonic() - t0 < deadline_s:
        _, body = _http("GET", base + "/status", timeout=30)
        text = json.loads(body)["text"]
        check(not text.startswith("error"), f"viewer render: {text}")
        if text.startswith("done"):
            return text, time.monotonic() - t0
        time.sleep(0.05)
    raise SmokeFailure(f"viewer render not done in {deadline_s} s: {text!r}")


def phase_viewer(torch, np, dev, card):
    """Phase 17: the web viewer on the card.  make_server with
    InitialSettings on 127.0.0.1 (port 0) in a temporary working
    directory: the page, a render with the page's defaults (Path, max
    depth 3, Stratified, 4 spp, 640x480, Filmic) polled to done, the PNG
    decoded and held against the tone-mapped film, debug rays at the
    film's centre for Path and (after a Whitted render) Whitted, the BVH
    overlay at level 3, the scene stats, both EXR exports read back, kill;
    then ``python -m yuki_tpu_torch --view --port 0`` as a subprocess
    whose /status must answer.  Every request and wait has a deadline.
    The launch counts are set to 0 before each render and debug ray and
    read after it: the Path render launches raygen_trace and bounce and
    nothing else, its film equals render_frame's with the page's settings
    bit for bit, and each debug ray launches dense_closest alone."""
    import queue
    import tempfile
    import threading

    from yuki_tpu_torch.app.exr import read_exr
    from yuki_tpu_torch.app.settings import InitialSettings
    from yuki_tpu_torch.app.viewer import make_server, srgb_bytes
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import StratifiedSampler
    from yuki_tpu_torch.tonemap import FilmicParams, filmic

    page = {"integrator": "Path", "max_depth": 3, "sampler": "Stratified",
            "spp": 4, "res": "640x480", "exposure": 1.0, "tonemap": "Filmic"}
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        srv = make_server(InitialSettings(), port=0, device=dev)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        state = srv.viewer_state
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            code, body = _http("GET", base + "/", timeout=30)
            check(code == 200 and b"yuki-tpu" in body
                  and b"%CAM_POS%" not in body, "viewer: index page")
            torch.cuda.synchronize()
            reset_all_launches()
            t0 = time.monotonic()
            _http("POST", base + "/render", page, timeout=60)
            text, _ = _wait_done(base, 300)
            render_s = time.monotonic() - t0
            torch.cuda.synchronize()
            render_counts = {k: v for k, v in all_launches().items() if v}
            check(set(render_counts) == {"raygen_trace", "bounce"},
                  f"viewer: the Path render launched {render_counts}, not "
                  "raygen_trace and bounce alone")
            t0 = time.monotonic()
            code, png = _http("GET", base + "/image.png", timeout=60)
            png_s = time.monotonic() - t0
            check(code == 200, f"viewer: /image.png status {code}")
            got = decode_png(np, png)
            film_img = state.film.image_device().cpu()
            want = srgb_bytes(filmic(film_img, FilmicParams()).numpy())
            check(got.shape == (480, 640, 3) and np.array_equal(got, want),
                  "viewer: the PNG differs from the tone-mapped film")
            check(float(film_img.mean()) > 0.0, "viewer: black film")
            ref = render_frame(state.scene, state.cam_params,
                               FilmSettings(res=(640, 480)),
                               StratifiedSampler(2, 2), PathParams(3))
            check(torch.equal(ref.film.image_device(),
                              state.film.image_device()),
                  "viewer: the film differs from render_frame's with the "
                  "page's settings")
            parts = []
            for kind in ("Path", "Whitted"):
                if kind == "Whitted":
                    torch.cuda.synchronize()
                    reset_all_launches()
                    _http("POST", base + "/render", dict(
                        page, integrator="Whitted", sampler="Uniform",
                        spp=1), timeout=60)
                    _wait_done(base, 300)
                    torch.cuda.synchronize()
                    whitted_counts = {k: v for k, v in
                                      all_launches().items() if v}
                    check(whitted_counts.get("dense_closest", 0) > 0,
                          f"viewer: the Whitted render launched "
                          f"{whitted_counts}")
                torch.cuda.synchronize()
                reset_all_launches()
                t0 = time.monotonic()
                _, body = _http("POST", base + "/debug_ray",
                                {"fx": 0.5, "fy": 0.5}, timeout=120)
                ms = (time.monotonic() - t0) * 1e3
                torch.cuda.synchronize()
                ray_counts = {k: v for k, v in all_launches().items() if v}
                check(set(ray_counts) == {"dense_closest"},
                      f"viewer: the {kind} debug ray launched {ray_counts}")
                segs = json.loads(body)["segments"]
                check(len(segs) >= 2 and abs(segs[0]["x0"] - 320) < 2
                      and abs(segs[0]["y0"] - 240) < 2,
                      f"viewer: {kind} debug ray segments {segs[:2]}")
                types = sorted({s["type"] for s in segs})
                parts.append(f"{kind} {len(segs)} segments {types} "
                             f"in {ms:.1f} ms, launches {ray_counts}")
            _, body = _http("GET", base + "/bvh?level=3", timeout=60)
            n_bvh = len(json.loads(body)["segments"])
            check(n_bvh > 0 and n_bvh % 12 == 0, f"viewer: bvh {n_bvh}")
            _, body = _http("GET", base + "/scene_stats", timeout=30)
            check("triangles: 36" in json.loads(body)["text"],
                  "viewer: scene stats")
            film_img = state.film.image_device().cpu()
            for tm, want in ((False, film_img.numpy()),
                             (True, filmic(film_img, FilmicParams()).numpy())):
                _, body = _http("POST", base + "/save_exr",
                                {"tonemapped": tm}, timeout=60)
                path = json.loads(body)["path"]
                img = read_exr(os.path.join(tmp, path))
                check(np.array_equal(img.view(np.uint32),
                                     want.view(np.uint32)),
                      f"viewer: {path} differs from the film")
            _http("POST", base + "/kill", timeout=60)
        finally:
            srv.shutdown()
            srv.server_close()
            state.renderer.kill()
            os.chdir(cwd)
        print(f"viewer make_server on the card: render with the page's "
              f"defaults (Path d3, Stratified 4 spp, 640x480, Filmic) "
              f"{render_s:.3f} s from POST to done ({text.splitlines()[0]}),"
              f" launches {render_counts}, film equal to render_frame's bit "
              f"for bit; /image.png {png_s * 1e3:.1f} ms ({len(png)} bytes) "
              f"equal to the tone-mapped film; Whitted render launches "
              f"{whitted_counts}; debug rays: {'; '.join(parts)}; bvh "
              f"level 3 {n_bvh // 12} boxes; both EXRs read back bit for "
              f"bit [{card}]")

        lines = queue.Queue()
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, "-m", "yuki_tpu_torch", "--view", "--port", "0"],
            cwd=tmp, env=dict(os.environ, PYTHONPATH=REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            threading.Thread(target=lambda: [lines.put(x)
                                             for x in proc.stdout],
                             daemon=True).start()
            url, seen = None, []
            while url is None:
                left = 120.0 - (time.monotonic() - t0)
                try:
                    line = lines.get(timeout=max(min(left, 1.0), 0.0))
                except queue.Empty:
                    check(left > 0 and proc.poll() is None,
                          f"viewer CLI: no URL line (exit {proc.poll()}): "
                          f"{''.join(seen)[-2000:]}")
                    continue
                seen.append(line)
                if "viewer on http://" in line:
                    url = line.strip().split("viewer on ")[1]
            up_s = time.monotonic() - t0
            code, body = _http("GET", url + "/status", timeout=30)
            check(code == 200 and "text" in json.loads(body),
                  "viewer CLI: /status")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=20)
    print(f"viewer CLI python -m yuki_tpu_torch --view --port 0: serving in "
          f"{up_s:.3f} s ({url}), /status answered, terminated [{card}]")


def phase_bundles(torch, np, scene, rays, card):
    """Phase 18: the bundle engine on the colonnade wave's bounce-1 rays
    and their shadow rays (sorted by ray_sort_key, as intersect sorts
    them).  The slot walks against their plain versions on a slice of
    bundle-slot rows (bun 4 closest, bun 8 occlusion with the skip ids);
    then intersect with bun_closest 4 and 8 and any_intersect with
    bun_any 8 against the default slot stream, the divergent branch forced
    (traverse._coherent False for both): prim and occlusion equal apart
    from counted ties, t within an ulp; each with its ms per call, slot
    rows, overflow rays and wide re-runs."""
    import dataclasses

    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_bundles as tb
    from yuki_tpu_torch.ops import trace_stream as ts

    o2, d2, t2, no2, nd2, nt2, sk2 = rays
    data, meta = scene.data, scene.meta
    ch = data.chunks
    k = ch.leaf_size

    def sorted_rays(*x):
        order = torch.argsort(traverse.ray_sort_key(data, x[0], x[1]),
                              stable=True)
        return [v[order].contiguous() for v in x]

    for what, bun, name, xs in (
            ("bounce-1 rays", 4, "slot_closest", sorted_rays(o2, d2, t2)),
            ("shadow rays", 8, "slot_any", sorted_rays(no2, nd2, nt2, sk2))):
        o, d, t = xs[:3]
        extra = xs[3].to(torch.float32) if name == "slot_any" else None
        c = meta.c_closest if name == "slot_closest" else meta.c_any
        mults = ((4 * meta.slot_mult_tight, 4 * meta.slot_mult + 4)
                 if name == "slot_closest" else
                 (4 * max(3, meta.slot_mult_tight - 1),
                  4 * max(4, meta.slot_mult - 2) + 4))
        bw = tb.bundle_words(ts.cross_words(ch, o, d, t), bun)
        _, slots = tb._bundle_slots(ch, bw, c, *mults, bun)
        check(slots is not None, f"bundles: the {what}' budget blew")
        _, slot_bun, row_chunk, valid = slots
        stream = tb._pack_bundles(o, d, t, extra, slot_bun, valid, bun)
        rows = min(row_chunk.numel(), 4096)
        rc, st = row_chunk[:rows].contiguous(), stream[:rows * 128]
        kern, plain = getattr(ts, name), getattr(ts, name + "_plain")
        got = kern(ch.rows, k, rc, st)
        ref = plain(ch.rows, k, rc, st)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"{name} on {what}' bundle-slot rows "
              "differs from its plain version")
        ms_k = cuda_ms(torch, lambda: kern(ch.rows, k, row_chunk, stream), 5)
        print(f"{name} on bundle-slot rows [{what}, bun {bun}, {rows} of "
              f"{row_chunk.numel()} rows, {int((st[:, 6] > 0).sum())} live "
              f"lanes]: equal to its plain version bit for bit; whole "
              f"stream {ms_k:.4f} ms [{card}]")

    saved = traverse._coherent
    traverse._coherent = lambda rw: False
    try:
        def run(label, m, closest):
            if closest:
                call = lambda: traverse.intersect(data, m, o2, d2, t2)
            else:
                call = lambda: traverse.any_intersect(data, m, no2, nd2, nt2,
                                                      sk2)
            traverse.reset_counts()
            out = call()
            torch.cuda.synchronize()
            c = traverse.counts()
            ms = cuda_ms(torch, call, 3)
            return out, c, ms

        base_c, cb, ms_c = run("slot", meta, True)
        base_a, ab, ms_a = run("slot", meta, False)
        check(cb["closest_slot"] == 1 and ab["any_slot"] == 1,
              f"bundles: the default engine was not the slot stream: {cb} "
              f"{ab}")
        lines = [f"slot stream: closest {ms_c:.3f} ms ({cb['slot_rows']} "
                 f"slot rows, {cb['overflow_rays']} overflow rays, "
                 f"{cb['wide_reruns']} wide re-runs), occlusion "
                 f"{ms_a:.3f} ms ({ab['slot_rows']} slot rows, "
                 f"{ab['overflow_rays']} overflow, {ab['wide_reruns']} "
                 "re-runs)"]
        for bun in (4, 8):
            m = dataclasses.replace(meta, bun_closest=bun)
            hit, c, ms = run(f"bun {bun}", m, True)
            check(c["closest_bundle"] == 1 and not c["fallbacks"],
                  f"bundles: bun_closest {bun} did not take the engine: {c}")
            ulp = (hit.t.view(torch.int32)
                   - base_c.t.view(torch.int32)).abs()
            same = hit.prim == base_c.prim
            ties = int((~same & (ulp <= 1)).sum())
            check(int((~same).sum()) == ties,
                  f"bundles: bun {bun}: prim differs beyond ties")
            max_ulp = int(ulp[same].max())
            check(max_ulp <= 1 and torch.equal(hit.hit, base_c.hit),
                  f"bundles: bun {bun}: t {max_ulp} ulps apart")
            lines.append(
                f"bun_closest {bun}: {ms:.3f} ms ({c['bundle_rows']} "
                f"bundle-slot rows = {c['bundle_rows'] * 128} lanes, "
                f"{c['overflow_rays']} overflow rays, {c['wide_reruns']} "
                f"wide re-runs; prim equal apart from {ties} ties, t within "
                f"{max_ulp} ulp)")
        m = dataclasses.replace(meta, bun_any=8)
        occ, c, ms = run("bun 8", m, False)
        check(c["any_bundle"] == 1 and not c["fallbacks"],
              f"bundles: bun_any 8 did not take the engine: {c}")
        n_occ = int((occ != base_a).sum())
        check(n_occ == 0, f"bundles: bun_any 8: {n_occ} verdicts differ")
        lines.append(f"bun_any 8: {ms:.3f} ms ({c['bundle_rows']} "
                     f"bundle-slot rows, {c['overflow_rays']} overflow, "
                     f"{c['wide_reruns']} re-runs; occlusion equal)")
    finally:
        traverse._coherent = saved
    print(f"bundle engine on the colonnade [{o2.shape[0]} bounce-1 rays, "
          f"{no2.shape[0]} shadow rays, sorted, divergent branch]: "
          f"{'; '.join(lines)} [{card}]")


def phase_parallel(torch, np, dev, card):
    """Phase 19: make_sharded_wave_renderer on one 4096-tile wave of the
    1080p Cornell film (Path d5, UniformSampler(1), 16-pixel tiles, seed
    1), meshes whose entries all name the card: 4 tiles shards, and 2 x 2
    tiles x samples (2 samples a launch), against the single-device
    renderer's path_li route (PATH_FUSED_MODE "off") over the same
    origins: tiles bit for bit, the samples axis equal to the summed
    generations, rays equal.  The launch counts are set to 0 before each
    render and read after it: every one launches dense_closest and shade,
    and nothing beyond path_li's kernels (dense_closest, dense_any, shade,
    resolve)."""
    from yuki_tpu_torch.camera import Camera
    from yuki_tpu_torch.film import FilmSettings, film_tiles
    from yuki_tpu_torch.integrators import PathParams
    from yuki_tpu_torch.ops import path_fused
    from yuki_tpu_torch.parallel import (default_mesh,
                                         make_sharded_wave_renderer)
    from yuki_tpu_torch.renderer import make_wave_renderer
    from yuki_tpu_torch.sampling import UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell

    scene, cam_p, _ = cornell(device=dev)
    cam = Camera.create(cam_p, *RES)
    tiles = film_tiles(FilmSettings(res=RES, tile_dim=16))[:WAVE_TILES]
    origins = torch.as_tensor([[t.x0, t.y0] for t in tiles],
                              dtype=torch.int32, device=dev)
    params, sampler = PathParams(max_depth=DEPTH), UniformSampler(1)
    path_li_kernels = {"dense_closest", "dense_any", "shade", "resolve"}

    def launched(what):
        torch.cuda.synchronize()
        counts = {k: v for k, v in all_launches().items() if v}
        check(counts.get("dense_closest", 0) > 0 and counts.get("shade", 0)
              > 0 and set(counts) <= path_li_kernels,
              f"parallel {what}: launched {counts}, not path_li's kernels")
        return counts

    saved = path_fused.PATH_FUSED_MODE
    path_fused.PATH_FUSED_MODE = "off"
    try:
        single = make_wave_renderer(scene, cam, sampler, params, 16,
                                    WAVE_TILES)
        reset_all_launches()
        (g0, r0), ms0 = timed_once(torch, lambda: single(origins, 0, 1))
        counts0 = launched("single device")
        g1, r1 = single(origins, 1, 1)
    finally:
        path_fused.PATH_FUSED_MODE = saved
    parts = []
    for shape, spl, want, want_r in (((4, 1), 1, g0, r0),
                                     ((2, 2), 2, g0 + g1, r0 + r1)):
        mesh = default_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
        fn = make_sharded_wave_renderer(scene, cam, sampler, params, 16, mesh,
                                        samples_per_launch=spl)
        reset_all_launches()
        (px, rays), ms = timed_once(torch, lambda: fn(origins, 0, 1))
        counts = launched(f"{shape}")
        check(torch.equal(px, want), f"parallel {shape}: tiles differ from "
              "the single-device render")
        check(float(rays) == float(want_r), f"parallel {shape}: rays "
              f"{float(rays)} != {float(want_r)}")
        parts.append(f"{shape[0]} x {shape[1]} mesh ({spl} sample(s) a "
                     f"launch) {ms:.1f} ms, launches {counts}, equal bit "
                     "for bit")
    check(float(g0.mean()) > 0.0, "parallel: black tiles")
    print(f"parallel Cornell {RES[0]}x{RES[1]} Path d{DEPTH} 1 spp, one "
          f"{WAVE_TILES}-tile wave, every mesh entry cuda:0: single device "
          f"(path_li) {ms0:.1f} ms, {int(float(r0))} rays, launches "
          f"{counts0}; "
          f"{'; '.join(parts)} [{card}]")


def phase_numpy_bvh(torch, np, scene, card):
    """Phase 20: the numpy BVH builder on the colonnade's triangles (sah,
    four shapes a leaf, as the scene builds) against the native builder,
    field for field, with both build times (host)."""
    from yuki_tpu_torch.bvh import build_bvh

    tr = scene.data.tris
    tri_p = np.stack([tr.p0.cpu().numpy(), tr.p1.cpu().numpy(),
                      tr.p2.cpu().numpy()], axis=1)
    times = {}
    hosts = {}
    for native in (True, False):
        t0 = time.monotonic()
        hosts[native] = build_bvh(tri_p, "sah", 4, use_native=native)
        times[native] = time.monotonic() - t0
    a, b = hosts[True], hosts[False]
    for f in ("node_lo", "node_hi", "prim_offset", "prim_count", "child0",
              "child1", "axis", "depth", "links", "prim_order"):
        x, y = getattr(a, f), getattr(b, f)
        check(x.shape == y.shape and x.tobytes() == y.tobytes(),
              f"numpy BVH builder: {f} differs from the native builder's")
    check(a.max_leaf == b.max_leaf, "numpy BVH builder: max_leaf differs")
    print(f"numpy BVH builder on the colonnade ({tri_p.shape[0]} triangles, "
          f"sah, 4 a leaf, {a.node_lo.shape[0]} nodes): every field equal to "
          f"the native builder's; native {times[True]:.3f} s, numpy "
          f"{times[False]:.3f} s (host) [{card}]")


def main():
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import yuki_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: FAIL: the yuki_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1

    try:
        t0 = time.monotonic()
        card = phase_device(torch)
        dev = torch.device("cuda")
        kernels = phase_kernels(torch, np, dev)
        phase_golden(torch, np, dev)
        launches = phase_main_path(torch, np, dev, card)
        kernels.update(phase_dense_kernels(torch, np, dev, card))
        launches.update(phase_dense_path_li(torch, np, dev, card))
        phase_strat_kernels(torch, np, dev, card)
        wave_kernels, wave_launches = phase_wave1k(torch, np, dev, card)
        kernels.update(wave_kernels)
        launches.update(wave_launches)
        phase_strat_frames(torch, np, dev, card)
        draw_kernels, draw_launches = phase_strat_draws(torch, np, dev, card)
        kernels.update(draw_kernels)
        launches.update(draw_launches)
        scene, cam = phase_colonnade_build(torch, np, dev)
        col_kernels, rays, wave0 = phase_colonnade_kernels(torch, np, dev,
                                                           scene, cam)
        kernels.update(col_kernels)
        kernels.update(phase_stream_kernels(torch, np, scene, rays, card))
        phase_dispatch_vs_walk(torch, scene, rays, card)
        kernels.update(phase_rows_kernels(torch, scene, wave0, card))
        kernels.update(phase_walker(torch, scene, rays, wave0, card))
        for walker in (False, True):
            phase_colonnade_golden(torch, np, scene, cam, walker)
        for walker in (False, True):
            launches.update(phase_colonnade_main_path(torch, np, scene, cam,
                                                      card, walker))
        phase_colonnade_strat(torch, np, scene, cam, card)
        t_new = time.monotonic()
        for phase in (lambda: phase_combined(torch, scene, rays, wave0, card),
                      lambda: phase_dense_combined(torch, dev, card),
                      lambda: phase_pairs(torch, scene, rays, card)):
            new_kernels, new_launches = phase()
            kernels.update(new_kernels)
            launches.update(new_launches)
        phase_sort(torch, scene, rays, card)
        print(f"phases 12-13a: {time.monotonic() - t_new:.1f} s")
        t_new = time.monotonic()
        phase_loaders(torch, np, dev, card)
        phase_atrium(torch, np, dev, card)
        phase_headless(torch, np, dev, card)
        phase_headless_defaults(torch, np, dev, card)
        print(f"phases 14-15: {time.monotonic() - t_new:.1f} s")
        t_new = time.monotonic()
        phase_whitted(torch, np, dev, card, scene, cam)
        whitted_kernels, whitted_launches = phase_whitted_kernels(
            torch, np, dev, card)
        kernels.update(whitted_kernels)
        launches.update(whitted_launches)
        phase_path_chain(torch, np, dev, card)
        phase_debug_views(torch, np, dev, card, scene, cam)
        print(f"phase 16: {time.monotonic() - t_new:.1f} s")
        t_new = time.monotonic()
        phase_viewer(torch, np, dev, card)
        phase_bundles(torch, np, scene, rays, card)
        phase_parallel(torch, np, dev, card)
        phase_numpy_bvh(torch, np, scene, card)
        print(f"phases 17-20: {time.monotonic() - t_new:.1f} s")
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=CSRC + src, replaces=replaces,
             launches=launches[name], library_ms=None, **kernels[name])
        for name, (src, replaces) in KERNELS.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
