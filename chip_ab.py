#!/usr/bin/env python3
"""A/B of the redesigned kernels (the two-level cull, the dense bounce,
the crossing words, the slot walks, raygen, the row-union walks, the dense
closest and occlusion sweeps, the shade kernel, the one-kernel wave, the
bundle walks, the block-pair walks and the treelet walks) between two
checkouts of this repository, on one NVIDIA GPU.

    python3 chip_ab.py run ROOT TAG OUT.json [PARTS]   # measure ROOT's port
    python3 chip_ab.py probe ROOT TAG OUT.json [PARTS [KERNELS]]
                                                       # the same, walks cut
    python3 chip_ab.py compare A.json B.json           # A against B

PARTS is a comma-separated subset of
bounce,wave,cull,stream,frames,rows,dense,shade,walker,pairs,treelets
(default: all), or raygen (bounce's raygen measurements alone) or rows_any
(rows' occlusion walk alone).

``probe`` copies ROOT's ``yuki_tpu_torch`` to ``build/probe-TAG/``, cuts
the walks of the occlusion slot walk, the row-union walks, the dense
closest and occlusion sweeps, the bundle walks, the block-pair walks, the
treelet walks and the raygen kernel's sweep to zero triangles (and raygen's to zero
spheres), the shade kernel's shading body to its loads, row gathers and
one draw and the wave kernel's bounces to none (its raygen alone), by a text edit of the copy's
sources (``PROBE_EDITS``; KERNELS, a comma-separated subset of its keys,
cuts those alone), and runs ``run`` on the copy: its times are those of
the kernels' stage, sort, rechecks, barriers, loads and stores alone.  Its
digests differ from ROOT's by design, and a wave made from a cut kernel's
hits (bounce-1 rays, shadow rays) is not the real one.

``run`` imports the ``yuki_tpu_torch`` package of the checkout at ROOT
(its kernels are built there, at first use) and records, on the card:

- the cull (``candidate_lists_fused``) on the bounce-1 rays and their
  shadow rays of the first 2048-tile wave of the 1080p colonnade (seed 1,
  made as ``chip_smoke.py`` phase 6 makes them): unsorted, as path_li
  hands them over, and sorted by ``traverse.ray_sort_key`` (the sorted
  wave's lists, permuted back, must equal the unsorted wave's);
- the bounce kernel at every bounce of the 1080p Cornell wave (4096 tiles,
  1,048,576 lanes, depth 5), under UniformSampler and under
  StratifiedSampler(4, 4)'s planes: as is, and with its input lanes
  (state planes, ``ph``, sampler planes) permuted by material class (dead,
  missed, then the hit's material type and surface kind), whose outputs,
  permuted back, must equal the unpermuted ones;
- the raygen kernel on the same wave under both samplers: its planes
  against ``raygen_trace_plain``'s (bit for bit or the largest
  difference), its kernel device time (torch.profiler), how the rays split
  over the three shear frames (the dominant axis of the direction) and
  how many distinct frames a block of 128 to 1024 consecutive rays holds;
- ``wave``: the one-kernel wave on the same Cornell wave under both
  samplers, timed a call and as the kernel's device time, beside the
  two-kernel wave (raygen + 5 bounce launches) in the same call, with the
  live lanes entering each bounce and, at each bounce, the 32-lane warps
  by distinct classes (dead lanes left out) in film order (one thread a
  lane, the first port's warps) and in the order of 512-lane tiles sorted
  by class, dead lanes dropped (the redesign's warps), from the two-kernel
  wave's state (``_wave_stats``);
- ``stream``: the crossing words on 1, 32 and all (2,217) of the cull's
  overflow rays of that bounce-1 wave, on its first 65,536 rays and on
  the whole wave (524,288 rays), with each wave's crossed word boxes per
  ray and a warp's union of them against their sum; the closest slot
  walk on the bounce-1 wave's slot rows, on the overflow rays' wide
  re-run (C_WIDE) and, with_skip, on the combined wave's (the bounce-1
  rays then their shadow rays, as ``chip_smoke.py`` phase 12 makes it),
  with the share of live slots and the real rows of the launched chunks;
  the occlusion slot walk on the shadow rays' slot rows, with the share
  of live slots that end occluded, the mean rows a slot tests up to its
  first occluder and the real rows of the unoccluded slots' chunks (from a
  plain torch walk); each timed a call (CUDA events) and as the kernel's
  device time (torch.profiler);
- ``rows``: the row-union closest walk on the colonnade wave's camera
  rays (524,288, the probe's own lists, as ``chip_smoke.py`` phase 8a
  makes them) and, with and without skip, on phase 12's sorted combined
  wave (camera + bounce-0 shadow lanes, 1,572,864); the occlusion row walk
  on the wave's bounce-0 shadow rays (1,048,576, light-major) forced
  through the rows engine, as phase 8a forces them, with its work from a
  plain walk (``_rows_any_stats``: walked chunks, the groups a row walks
  (G + 1) against the chunk's, rows each lane tests up to its first
  occluder, the non-crossing lanes the walk occludes, rows with no live
  lane, barriers per list entry in both designs); ``dense``: the dense
  closest sweep on Cornell's 1080p camera wave (1,048,576 rays), on the
  path_li frame's bounce-1 rays, on a 4096-triangle soup (65,536 rays,
  ``chip_smoke.py``'s) and, with and without skip, on phase 12a's
  combined wave (2,097,152 lanes); the dense occlusion sweep on the
  shadow rays of bounces 0 and 1 of the first wave of Cornell's 1080p
  path_li frame (as path_li hands them over) and on the soup; each timed
  a call and as the kernel's device time, with the statistics of its work
  from a plain torch walk that must give the kernel's output
  (``_rows_stats``, ``_dense_stats``, ``_any_dense_stats``);
- ``walker``: the bundle walks on the colonnade wave's lists (the
  crossing words, C_WALK, as ``chip_smoke.py`` phase 8b makes them): the
  closest walk on its bounce-1 rays (524,288) and, with and without skip,
  on phase 12's combined wave (the bounce-1 rays, then their shadow rays:
  1,572,864); the occlusion walk on its bounce-0 shadow rays (1,048,576);
  each timed a call and as the kernel's device time, with its work from a
  plain walk that must give the kernel's output (``_walker_stats``: list
  entries, the share walked and the live rays a walked entry, the real
  rows of the walked chunks, bundles with an empty list and by distinct
  shear frames among their live rays, the closest walk's entries after
  which some slot took a hit, the occlusion walk's entries met with all 8
  rays dead or occluded);
- ``pairs``: the block-pair walks on ``chip_smoke.py`` phase 13's waves
  (the bounce-1 rays and their shadow rays, each sorted by
  ``ray_sort_key``, at yuki_tpu's pair capacity), on the phase's 8-block
  slice and the whole wave, each timed a call and as the kernel's device
  time, with the pairs a block (mean, 99th percentile, max) and the
  slice's work from a plain walk that must give the kernel's output
  (``_pairs_stats``: pairs visited, yes votes and live lanes a visited
  pair, the visited treelets' real rows, blocks by distinct shear frames,
  the tests the block contract forces; closest: the visited pairs after
  which a lane took a hit; occlusion: the lanes of S, the rows walked
  (r* + 1), the lanes testing each row in the first port's schedule and
  the redesign's);
- ``treelets``: the treelet walks (the dispatch's fallback) on
  ``chip_smoke.py`` phase 6's four workloads: the closest walk on the
  colonnade wave's camera rays and its bounce-1 rays, the occlusion walk
  on its bounce-0 and bounce-1 shadow rays, each on the phase's slice and
  the whole wave, timed a call and as the walk's device time (and the
  vote count's, for a closest walk that orders its blocks), with the
  slice's work from ``chip_smoke.treelet_work`` (a plain walk that must
  give the kernel's output: super and treelet visits, a block's visits,
  live lanes and real rows a visit, the contract's floor); on the bounce-1
  waves the closest walk of a checkout that launches its blocks most
  votes first also in launch order (``_launch_order``), and a walk that
  launches them in order also with its rays permuted most votes first
  (``_permuted``);
- ``shade``: the shade kernel at every bounce of the first wave of
  Cornell's 1080p d5 1 spp path_li frame and of the colonnade's 1080p d5
  frame under UniformSampler(1) and StratifiedSampler(2, 2) (its planes),
  on the lanes path_li hands it (chip_smoke.py's ``_capture``): a call's time, the
  kernel's device time, the same lanes permuted by class (dead, then the
  material type and surface) with the outputs permuted back bit for bit,
  the share of dead lanes and the warps by distinct classes;
- the 1080p d5 16 spp Cornell frame, by the two-kernel and the one-kernel
  wave, the 1080p d5 1 spp Cornell frame
  through path_li (the dense sweeps' main path) and the 1080p d5 1 spp
  colonnade frame on the slot stream and with both walker flags (the
  median of three after one warm-up), and one of each under
  torch.profiler: device busy time, idle share and the redesigned
  kernels' device time;
- each of those kernels' ``-Xptxas -v`` lines;

and writes the times with a SHA-256 digest of every kernel output to
OUT.json.  ``compare`` prints the times side by side and exits 1 unless
every digest of A equals B's (the kernels' outputs bit for bit).
"""

import hashlib
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEPTH = 5
SPP = 16
CORNELL_TILES = 4096
COL_TILES = 2048
SLICE_RAYS = 65536  # the crossing words' slice of the bounce-1 wave
KERNEL_NAMES = ("cull_kernel", "bounce_kernel", "wave_kernel",
                "raygen_trace_kernel", "cross_words_kernel",
                "slot_closest_kernel", "slot_any_kernel",
                "rows_closest_kernel", "rows_any_kernel",
                "dense_closest_kernel", "dense_any_kernel", "shade_kernel",
                "walker_closest_kernel", "walker_any_kernel",
                "pairs_closest_kernel", "pairs_any_kernel",
                "treelet_closest_kernel", "treelet_any_kernel",
                "treelet_votes_kernel")
DENSE_KERNELS = ("dense_closest_kernel", "dense_any_kernel", "shade_kernel")
COL_KERNELS = ("cull_kernel", "cross_words_kernel", "slot_closest_kernel",
               "slot_any_kernel", "rows_closest_kernel", "rows_any_kernel",
               "walker_closest_kernel", "walker_any_kernel", "shade_kernel")
N_CLASSES = 9  # the shade kernel's lane classes: dead, then 2 mtype + sphere
# The probe's edits: for each kernel, alternatives (source, old, new), of
# which exactly one must occur once in the checkout's source (the code
# before the kernel's redesign, or after it), or have been made already by
# another kernel's edit of a shared header; each cuts the kernel's walk to
# zero triangles and leaves its stage, loads and stores.
FIRST_BLOCKER_EDIT = (
    "trace_treelets.cuh", "  for (int r = 0; r < n; ++r) {\n"
    "    const float4 a = tri[3 * r]",
    "  for (int r = n; r < n; ++r) {\n    const float4 a = tri[3 * r]")
PROBE_EDITS = {
    "slot_any_kernel": (
        ("trace_stream.cu", "for (int r = 0; r < k; ++r) {",
         "for (int r = 0; r < 0; ++r) {"),
        ("trace_stream.cu", "for (int r = 0; r < last; ++r) {",
         "for (int r = 0; r < 0; ++r) {"),
        # first_occluder, which rows_any_kernel shares.
        ("trace_stream.cuh", "  for (int r = 0; r < n; ++r) {\n"
         "    const float4* t = tri + 3 * r;",
         "  for (int r = n; r < n; ++r) {\n"
         "    const float4* t = tri + 3 * r;"),
    ),
    "raygen_trace_kernel": (
        ("path_fused.cu", "seed, ms, sc, spl ? spl + i : nullptr, N, ph);",
         "seed, ms, Scene{0, 0}, spl ? spl + i : nullptr, N, ph);"),
        ("path_fused.cu", "camera_sweep(copy, sc.n_tris, sc.sp(), sc.n_spheres,",
         "camera_sweep(copy, 0, sc.sp(), 0,"),
    ),
    "rows_closest_kernel": (
        ("trace_rows.cu",
         "closest_chunk<WITH_SKIP>(sh, r.o, tri_s, k, ts, det, prim, sk);",
         "closest_chunk<WITH_SKIP>(sh, r.o, tri_s, 0, ts, det, prim, sk);"),
        ("trace_rows.cu",
         "closest_framed<WITH_SKIP>(sh, of, copy, (last + 7) & ~7, ts,",
         "closest_framed<WITH_SKIP>(sh, of, copy, 0, ts,"),
    ),
    "dense_closest_kernel": (
        ("trace_dense.cu",
         "for (int r = 0; r < m; ++r) {\n      float ti, bi0, bi1;\n"
         "      if (hit9(sh, ro, t,",
         "for (int r = 0; r < 0; ++r) {\n      float ti, bi0, bi1;\n"
         "      if (hit9(sh, ro, t,"),
        ("trace_dense.cu",
         "for (int r = 0; r < m; ++r) {\n      // Row r of the frame's copy",
         "for (int r = 0; r < 0; ++r) {\n      // Row r of the frame's copy"),
    ),
    "dense_any_kernel": (
        ("trace_dense.cu",
         "for (int r = 0; r < m; ++r) {\n      float ti, bi0, bi1;\n"
         "      if (hit9(sh, ro, tm,",
         "for (int r = 0; r < 0; ++r) {\n      float ti, bi0, bi1;\n"
         "      if (hit9(sh, ro, tm,"),
        ("trace_dense.cu",
         "for (int r = 0; r < m; ++r) {\n      // Row r in the lane's frame",
         "for (int r = 0; r < 0; ++r) {\n      // Row r in the lane's frame"),
    ),
    # The occlusion row walk: no triangle (the first port's groups, or the
    # redesign's first_occluder, cut above: this alternative edits nothing
    # and only names that form), so its rechecks, votes, stages and
    # barriers alone; no lane is occluded, so a row walks every entry some
    # lane crosses.
    "rows_any_kernel": (
        ("trace_rows.cu", "for (int g = 0; g < k; g += 8) {",
         "for (int g = 0; g < 0; g += 8) {"),
        ("trace_rows.cu", "rf = first_occluder(sh, of, copy, last, r.tm, sk);",
         "rf = first_occluder(sh, of, copy, last, r.tm, sk);"),
    ),
    # The wave kernel's bounces: none (the first port's loop, or the
    # redesign's), so its raygen, stage and stores alone.
    "wave_kernel": (
        ("path_fused.cu",
         "for (int b = 0; b < a.max_depth && p.alive > 0.0f; ++b) {",
         "for (int b = 0; b < 0 && p.alive > 0.0f; ++b) {"),
        ("path_fused.cu", "for (int b = 0; b < a.max_depth; ++b) {",
         "for (int b = 0; b < 0; ++b) {"),
    ),
    # The bundle walks: no triangle (the first port's slot loops, or the
    # redesign's slab tests), so the chain of list, rechecks, row loads and
    # fold alone.
    "walker_closest_kernel": (
        ("trace_walker.cu", "    if (j < k) {\n      const float* c = tri_s + "
         "12 * j;\n      const float pid = c[10];",
         "    if (j < 0) {\n      const float* c = tri_s + "
         "12 * j;\n      const float pid = c[10];"),
        ("trace_walker.cu",
         "        if (c.z >= 0.0f) {\n          const int slot",
         "        if (c.z < -2.0f) {\n          const int slot"),
    ),
    "walker_any_kernel": (
        ("trace_walker.cu", "    if (j < k) {\n      const float* c = tri_s + "
         "12 * j;\n      if (c[10] >= 0.0f) {",
         "    if (j < 0) {\n      const float* c = tri_s + "
         "12 * j;\n      if (c[10] >= 0.0f) {"),
        ("trace_walker.cu",
         "          if (c.z >= 0.0f) {\n            if (m & fr[0]) hit",
         "          if (c.z < -2.0f) {\n            if (m & fr[0]) hit"),
    ),
    # The block-pair walks: no row (the first port's loops, or the
    # redesign's walks), so the chain of pair loads, votes, stages and
    # barriers alone; the closest walk's t never falls, so it visits more
    # pairs than the real walk (an upper bound), and no lane is occluded.
    "pairs_closest_kernel": (
        ("trace_pairs.cu", "    for (int r = 0; r < k; ++r) {\n"
         "      const float* c = rows_s + 12 * r;\n      float ti, bi0, bi1;\n"
         "      const bool hit = watertight9(l.sh, l.o, t, ",
         "    for (int r = 0; r < 0; ++r) {\n"
         "      const float* c = rows_s + 12 * r;\n      float ti, bi0, bi1;\n"
         "      const bool hit = watertight9(l.sh, l.o, t, "),
        ("trace_pairs.cu", "for (int r = 0; r < last; ++r) {\n"
         "              const float4 a = copy[3 * r]",
         "for (int r = 0; r < 0; ++r) {\n"
         "              const float4 a = copy[3 * r]"),
    ),
    "pairs_any_kernel": (
        ("trace_pairs.cu", "    for (int r = 0; r < k; ++r) {\n"
         "      const float* c = rows_s + 12 * r;\n      float ti, bi0, bi1;\n"
         "      const bool hit =\n          watertight9(l.sh, l.o, t_max,",
         "    for (int r = 0; r < 0; ++r) {\n"
         "      const float* c = rows_s + 12 * r;\n      float ti, bi0, bi1;\n"
         "      const bool hit =\n          watertight9(l.sh, l.o, t_max,"),
        # first_blocker, both walks of a visited treelet (in
        # trace_pairs.cu before it was shared).
        ("trace_pairs.cu", "  for (int r = 0; r < n; ++r) {\n"
         "    const float4 a = tri[3 * r]",
         "  for (int r = n; r < n; ++r) {\n"
         "    const float4 a = tri[3 * r]"),
        FIRST_BLOCKER_EDIT,
    ),
    # The treelet walks: no row (the first port's loops, or the
    # redesign's closest walk and first_blocker; trace_treelets.cuh shares
    # first_blocker with the pair walks, so cutting either occlusion walk
    # there cuts both); the closest walk's t never falls, so it visits
    # more boxes than the real walk (an upper bound), and no lane is
    # occluded.
    "treelet_closest_kernel": (
        ("trace_treelets.cu", "      for (int r = 0; r < k; ++r) {\n"
         "        const float* c = rows_s + 12 * r;\n        float ti, bi0, "
         "bi1;\n        bool hit = watertight9(l.sh, l.o, t, ",
         "      for (int r = 0; r < 0; ++r) {\n"
         "        const float* c = rows_s + 12 * r;\n        float ti, bi0, "
         "bi1;\n        bool hit = watertight9(l.sh, l.o, t, "),
        ("trace_treelets.cu", "for (int r = 0; r < last; ++r) {\n"
         "                  const float4 a = copy[3 * r]",
         "for (int r = 0; r < 0; ++r) {\n"
         "                  const float4 a = copy[3 * r]"),
    ),
    "treelet_any_kernel": (
        ("trace_treelets.cu", "      for (int r = 0; r < k; ++r) {\n"
         "        const float* c = rows_s + 12 * r;\n        float ti, bi0, "
         "bi1;\n        bool hit =\n            watertight9(l.sh, l.o, "
         "t_max,",
         "      for (int r = 0; r < 0; ++r) {\n"
         "        const float* c = rows_s + 12 * r;\n        float ti, bi0, "
         "bi1;\n        bool hit =\n            watertight9(l.sh, l.o, "
         "t_max,"),
        FIRST_BLOCKER_EDIT,
    ),
    # The shading body: the lane keeps its plane loads, its row gathers
    # and one draw, and writes the fixed planes (not the lights').
    "shade_kernel": (
        ("shade_fused.cu",
         "ShadeOut so = shade_lane(tb, in, r, mt, urand, bounce, sink);",
         "ShadeOut so = {in.o, add(in.d, v3(in.t_hit + in.b0 + in.b1, "
         "r.trp[0] + r.mrow[0] + mt.s0, urand(0))), in.beta, in.alive, "
         "in.spec > 0.0f};"),
    ),
}
PROBING = False  # set by ``probe``: the walks are cut, skip their checks


def _smoke():
    """chip_smoke.py beside this file, for its wave builders and timer."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:20]


def _kernel_key(line):
    """The name in KERNEL_NAMES that a ptxas line's mangled name holds,
    with a bool template argument as <true> or <false>."""
    k = next((k for k in KERNEL_NAMES if k in line), None)
    if k is not None and "ILb1E" in line:
        return k + "<true>"
    if k is not None and "ILb0E" in line:
        return k + "<false>"
    return k


def ptxas_lines(report):
    """The ptxas lines of the kernels in KERNEL_NAMES: {kernel: [line]}."""
    out, cur = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            cur = _kernel_key(line)
            if "Compiling" in line:
                continue
        if cur is not None and ("registers" in line or "spill" in line
                                or "stack" in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


def material_class(torch, tpf, tb, st):
    """Each lane's class: 0 dead, 1 missed, else 2 + 2 mtype + (sphere
    hit), from the state planes and the wave's tables."""
    S = tpf._ST
    alive = st[S["alive"]] > 0.0
    hitf = st[S["hitf"]] > 0.0
    sph = st[S["sph"]]
    mid = tb.trs[st[S["prim"]].clamp(min=0.0).long(), 26]
    is_sph = sph >= 0.0
    if tb.n_spheres:
        si = sph.clamp(0, tb.n_spheres - 1).long()
        valid = is_sph & (sph < tb.n_spheres) & (si.float() == sph)
        mid = torch.where(valid, tb.sp[si, 34], mid)
    mtype = tb.mat[mid.clamp(min=0.0).long(), 0].long()
    return torch.where(~alive, 0, torch.where(
        ~hitf, 1, 2 + 2 * mtype + is_sph.long()))


def device_times(torch, prof, names):
    """(busy ms, {name: (ms, launches) in kernels whose name holds it}) of
    a profile.  The pass_scope ranges' device spans repeat their kernels'
    time and are left out."""
    from yuki_tpu_torch.profiling import SCOPES

    busy, parts = 0.0, {k: [0.0, 0] for k in names}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU or getattr(
                e, "is_user_annotation", False) or e.key in SCOPES:
            continue
        t = float(getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3
        busy += t
        for k in names:
            if k in e.key:
                parts[k][0] += t
                parts[k][1] += int(e.count)
    return busy, {k: tuple(v) for k, v in parts.items()}


def run(root, tag, out_path,
        parts="bounce,wave,cull,stream,frames,rows,dense,shade,walker,pairs,"
              "treelets"):
    parts = set(parts.split(","))
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np  # noqa: F401
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: FAIL: no CUDA card", file=sys.stderr)
        return 1
    import yuki_tpu_torch

    pkg = os.path.dirname(os.path.abspath(yuki_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        print(f"chip_ab: FAIL: imported {pkg}, not {root}'s", file=sys.stderr)
        return 1
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.film import FilmSettings
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import _build
    from yuki_tpu_torch.ops import path_fused as tpf
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace_cull as tcu
    from yuki_tpu_torch.ops import trace_stream as ts
    from yuki_tpu_torch.ops.trace import F32_MAX
    from yuki_tpu_torch.renderer import render_frame
    from yuki_tpu_torch.sampling import StratifiedSampler, UniformSampler
    from yuki_tpu_torch.scene.cornell import cornell
    from yuki_tpu_torch.scene.testscenes import colonnade
    from torch.profiler import ProfilerActivity, profile

    sm = _smoke()
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    t0 = time.monotonic()
    _build.library()
    res = dict(tag=tag, root=os.path.abspath(root), card=card,
               build_s=time.monotonic() - t0,
               ptxas=ptxas_lines(_build.ptxas_report), hashes={}, ms={},
               notes={})
    print(f"[{tag}] {card}; build {res['build_s']:.1f} s")
    for k, lines in res["ptxas"].items():
        print(f"[{tag}] ptxas {k}: {' | '.join(lines)}")

    def ms(fn, reps=20):
        return sm.cuda_ms(torch, fn, reps)

    # ---- the dense bounce on the Cornell wave ----------------------------
    tb, px, py = sm._cornell_wave(torch, dev)
    n = px.shape[0]
    for sam_name, sam, si in (("uniform", None, 0),
                              ("strat", StratifiedSampler(4, 4), 5)):
        if not parts & {"bounce", "raygen"}:
            break
        spl = tpf.strat_planes(sam, px, py, si, 1, tb.n_lights, DEPTH)
        st, ph = tpf.raygen_trace(px, py, si, 1, tb,
                                  None if spl is None else spl[:2])
        res["hashes"][f"raygen {sam_name}"] = digest(st)
        res["ms"][f"raygen {sam_name}"] = ms(lambda: tpf.raygen_trace(
            px, py, si, 1, tb, None if spl is None else spl[:2]))
        res["ms"][f"raygen {sam_name}: kernel device time"] = \
            kernel_device_ms(torch, lambda: tpf.raygen_trace(
                px, py, si, 1, tb, None if spl is None else spl[:2]),
                "raygen_trace_kernel")
        st_pl, ph_pl = tpf.raygen_trace_plain(
            px, py, si, 1, tb, None if spl is None else spl[:2])
        rs = _raygen_stats(torch, tpf, st, ph, st_pl, ph_pl)
        res["notes"][f"raygen {sam_name}"] = rs
        print(f"[{tag}] raygen {sam_name} [{n} rays]: "
              f"{res['ms'][f'raygen {sam_name}']:.4f} ms a call, kernel "
              f"device time "
              f"{res['ms'][f'raygen {sam_name}: kernel device time']:.4f} "
              f"ms; against the plain version: {rs['plain']}; rays by "
              f"shear frame (z, x, y) {rs['frames']}; blocks by distinct "
              f"frames (1, 2, 3) {rs['blocks']}")
        if "bounce" not in parts:
            continue
        for b in range(DEPTH):
            planes = tpf._bounce_planes(spl, tb, b)
            out = tpf.bounce(st, ph, b, tb, planes)
            res["hashes"][f"bounce {b} {sam_name}"] = digest(out)
            cls = material_class(torch, tpf, tb, st)
            perm = torch.argsort(cls, stable=True)
            inv = torch.argsort(perm)
            st_p = st[:, perm].contiguous()
            ph_p = ph[perm].contiguous()
            pl_p = None if planes is None else planes[:, perm].contiguous()
            out_p = tpf.bounce(st_p, ph_p, b, tb, pl_p)
            torch.cuda.synchronize()
            if not torch.equal(out_p[:, inv].view(torch.int32),
                               out.view(torch.int32)):
                print(f"chip_ab: FAIL: bounce {b} {sam_name}: permuted "
                      "lanes give other bits", file=sys.stderr)
                return 1
            t_as = ms(lambda: tpf.bounce(st, ph, b, tb, planes))
            t_sorted = ms(lambda: tpf.bounce(st_p, ph_p, b, tb, pl_p))
            counts = torch.bincount(cls, minlength=10).tolist()
            res["ms"][f"bounce {b} {sam_name}"] = t_as
            res["ms"][f"bounce {b} {sam_name}, lanes by material"] = t_sorted
            res["notes"][f"bounce {b} {sam_name} classes"] = counts
            print(f"[{tag}] bounce {b} {sam_name} [{n} lanes, classes "
                  f"{counts}]: {t_as:.4f} ms as is, {t_sorted:.4f} ms with "
                  f"lanes by material ({t_sorted / t_as:.3f}x)")
            st = out
    if "wave" in parts:
        rc = _wave(torch, tpf, res, tag, ms, tb, px, py)
        if rc:
            return rc

    # ---- the dense sweeps on Cornell's waves and a soup -----------------
    fs = FilmSettings(res=(1920, 1080), tile_dim=16)
    cscene, ccam, _ = cornell(device=dev)

    def cornell_path_li(sampler=None):
        tpf.PATH_FUSED_MODE = "off"
        try:
            return render_frame(cscene, ccam, fs, sampler or UniformSampler(1),
                                PathParams(DEPTH), wave_tiles=CORNELL_TILES,
                                seed=1)
        finally:
            tpf.PATH_FUSED_MODE = "auto"

    if parts & {"dense", "shade"}:
        # The first wave's shade and dense occlusion calls, as path_li
        # makes them.
        cornell_calls = sm._capture(torch, cornell_path_li, {
            (tsf, "shade_planes"): DEPTH, (traverse, "any_trace"): 2})
    if "dense" in parts:
        _dense(torch, sm, res, tag, ms, cornell_calls["any_trace"])

    # ---- the cull on the colonnade's bounce-1 and shadow rays -------------
    if not parts & {"cull", "stream", "frames", "rows", "rows_any", "shade",
                    "walker", "pairs", "treelets"}:
        return _write(res, out_path)
    scene, cam, _ = colonnade(device=dev)

    def colonnade_frame(walker, sampler=None):
        def frame():
            sm._walker_flags(walker)
            try:
                return render_frame(scene, cam, fs,
                                    sampler or UniformSampler(1),
                                    PathParams(DEPTH), wave_tiles=COL_TILES,
                                    seed=1)
            finally:
                sm._walker_flags(False)
        return frame

    # ---- the shade kernel at every bounce of the first wave -------------
    if "shade" in parts:
        cases = [("Cornell path_li uniform",
                  cornell_calls["shade_planes"])]
        for sam_name, sam in (("uniform", None),
                              ("strat", StratifiedSampler(2, 2))):
            calls = sm._capture(torch, colonnade_frame(False, sam),
                             {(tsf, "shade_planes"): DEPTH})
            cases.append((f"colonnade {sam_name}", calls["shade_planes"]))
        rc = _shade(torch, tsf, res, tag, ms, cases)
        if rc:
            return rc
    if not parts & {"cull", "stream", "frames", "rows", "rows_any", "walker",
                    "pairs", "treelets"}:
        return _write(res, out_path)
    ctx, o, d = sm._camera_wave(torch, dev, cam, COL_TILES)
    t_max = torch.full((o.shape[0],), F32_MAX, device=dev)
    n_lights = len(scene.meta.light_types)
    hit = traverse.intersect(scene.data, scene.meta, o, d, t_max,
                             skip_sort=True)
    tables = tsf.make_shade_tables(scene, PathParams(DEPTH))
    ph = _ph_i32(ctx)
    ones = torch.ones_like(o)
    out0 = tsf.shade_fused(tables, hit, o, d, ones, hit.hit,
                           torch.zeros_like(hit.hit), ph, 2, 0)
    o2, d2, beta2, alive2, spec2 = out0[:5]
    t2 = torch.where(alive2, F32_MAX, 0.0).to(torch.float32)
    hit2 = traverse.intersect(scene.data, scene.meta, o2, d2, t2,
                              skip_sort=True)
    (_, _, _, _, _, no2, nd2, nt2, sk2, *_rest) = tsf.shade_fused(
        tables, hit2, o2, d2, beta2, alive2 & hit2.hit, spec2, ph,
        2 + 2 * n_lights + 3, 1)
    ch = scene.data.chunks
    for what, (wo, wd, wt) in (("bounce-1 rays", (o2, d2, t2)),
                               ("shadow rays", (no2, nd2, nt2))):
        if "cull" not in parts:
            break
        lists, ov = tcu.candidate_lists_fused(ch, wo, wd, wt, ts.C_MAIN)
        res["hashes"][f"cull {what} lists"] = digest(lists)
        res["hashes"][f"cull {what} overflow"] = digest(ov)
        order = torch.argsort(traverse.ray_sort_key(scene.data, wo, wd),
                              stable=True)
        so, sd, st_ = (x[order].contiguous() for x in (wo, wd, wt))
        s_lists, s_ov = tcu.candidate_lists_fused(ch, so, sd, st_, ts.C_MAIN)
        back = torch.empty_like(s_lists)
        back[order] = s_lists
        back_ov = torch.empty_like(s_ov)
        back_ov[order] = s_ov
        torch.cuda.synchronize()
        if not (torch.equal(back, lists) and torch.equal(back_ov, ov)):
            print(f"chip_ab: FAIL: cull on sorted {what} differs",
                  file=sys.stderr)
            return 1
        t_un = ms(lambda: tcu.candidate_lists_fused(ch, wo, wd, wt,
                                                    ts.C_MAIN))
        t_so = ms(lambda: tcu.candidate_lists_fused(ch, so, sd, st_,
                                                    ts.C_MAIN))
        res["ms"][f"cull {what}"] = t_un
        res["ms"][f"cull {what}, sorted"] = t_so
        print(f"[{tag}] cull {what} [{wo.shape[0]} rays, "
              f"{int((wt > 0).sum())} live, {int(ov.sum())} overflow]: "
              f"{t_un:.4f} ms unsorted, {t_so:.4f} ms sorted "
              f"({t_un / t_so:.2f}x)")

    # ---- the crossing words and the slot walks --------------------------
    if "stream" in parts:
        rc = _stream(torch, sm, res, tag, scene, (o2, d2, t2),
                     (no2, nd2, nt2, sk2), ms)
        if rc:
            return rc

    # ---- the row-union walks ---------------------------------------------
    if parts & {"rows", "rows_any"}:
        rc = _rows(torch, sm, res, tag, scene, (o, d, t_max, *out0[5:9]), ms,
                   "rows" in parts)
        if rc:
            return rc

    # ---- the bundle walks --------------------------------------------------
    if "walker" in parts:
        rc = _walker(torch, sm, res, tag, scene, (o2, d2, t2),
                     (no2, nd2, nt2, sk2), out0[5:9], ms)
        if rc:
            return rc

    # ---- the block-pair walks ----------------------------------------------
    if "pairs" in parts:
        rc = _pairs(torch, sm, res, tag, scene, (o2, d2, t2),
                    (no2, nd2, nt2, sk2), ms)
        if rc:
            return rc

    # ---- the treelet walks (the dispatch's fallback) ----------------------
    if "treelets" in parts:
        rc = _treelets(torch, sm, res, tag, scene, (o, d, t_max), out0[5:9],
                       (o2, d2, t2), (no2, nd2, nt2, sk2), ms)
        if rc:
            return rc

    # ---- frames ---------------------------------------------------------
    def cornell_16spp(one_kernel):
        def frame():
            tpf.PATH_FUSED_ONEKERNEL = one_kernel
            try:
                return render_frame(cscene, ccam, fs, UniformSampler(SPP),
                                    PathParams(DEPTH),
                                    wave_tiles=CORNELL_TILES,
                                    samples_per_launch=SPP, seed=1)
            finally:
                tpf.PATH_FUSED_ONEKERNEL = False
        return frame

    frames = {
        "cornell 1080p d5 16 spp": (cornell_16spp(False), ("bounce_kernel",)),
        "cornell 1080p d5 16 spp, one kernel": (cornell_16spp(True),
                                                ("wave_kernel",)),
        "cornell 1080p d5 1 spp, path_li": (cornell_path_li, DENSE_KERNELS),
        "colonnade 1080p d5 1 spp": (colonnade_frame(False), COL_KERNELS),
        "colonnade 1080p d5 1 spp, walker": (colonnade_frame(True),
                                             COL_KERNELS),
    }
    for what, (frame, kerns) in frames.items():
        if "frames" not in parts:
            break
        r = frame()
        res["hashes"][f"frame {what}"] = digest(torch.as_tensor(
            r.film.image()))
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            secs.append(frame().elapsed_s)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_p = time.monotonic()
            frame()
            torch.cuda.synchronize()
            t_p = time.monotonic() - t_p
        busy, kt = device_times(torch, prof, kerns)
        med = statistics.median(secs)
        res["ms"][f"frame {what}"] = med * 1e3
        res["ms"][f"frame {what}: device busy (profiled)"] = busy
        for k, (t_k, n_k) in kt.items():
            if n_k:
                res["ms"][f"frame {what}: {k} (profiled)"] = t_k
                res["notes"][f"frame {what}: {k} launches"] = n_k
        res["notes"][f"frame {what}"] = dict(
            seconds=secs, profiled_wall_ms=t_p * 1e3,
            image_mean=float(r.film.image().mean()), rays=r.ray_count)
        per_kernel = ", ".join(f"{k} {t_k:.3f} ms / {n_k}"
                               for k, (t_k, n_k) in kt.items() if n_k)
        print(f"[{tag}] frame {what}: {med:.4f} s (of {secs}); under the "
              f"profiler wall {t_p * 1e3:.3f} ms, device busy {busy:.3f} ms "
              f"(idle {100 * (1 - busy / (med * 1e3)):.1f}% of the "
              f"unprofiled frame), {per_kernel}; image mean "
              f"{float(r.film.image().mean()):.5f}")
    return _write(res, out_path)


def _raygen_stats(torch, tpf, st, ph, st_pl, ph_pl):
    """The raygen kernel's planes against the plain version's ("equal" or
    the planes that differ with their largest difference), its rays by
    shear frame (0: z, 1: x, 2: y, as the watertight test picks the
    dominant axis) and, for blocks of 128 to 1024 consecutive rays, how
    many blocks hold 1, 2 and 3 distinct frames."""
    S = tpf._ST
    diff = {k: float((st[i] - st_pl[i]).abs().max()) for k, i in S.items()
            if not torch.equal(st[i].view(torch.int32),
                               st_pl[i].view(torch.int32))}
    plain = "equal" if not diff and torch.equal(ph, ph_pl) else diff
    frame = shear_frames(torch, st[S["dx"]:S["dz"] + 1].T)
    return dict(plain=plain,
                frames=torch.bincount(frame, minlength=3).tolist(),
                blocks={size: distinct_frames(torch, frame, size)
                        for size in (128, 256, 512, 1024)})


def shear_frames(torch, d):
    """Each ray's shear frame from its direction [N, 3]: 0 when z is the
    dominant axis, 1 for x, 2 for y, as the watertight test picks it."""
    ad = d.abs()
    x_max = (ad[:, 0] > ad[:, 1]) & (ad[:, 0] > ad[:, 2])
    y_max = ~x_max & (ad[:, 1] > ad[:, 2])
    return torch.where(x_max, 1, torch.where(y_max, 2, 0))


def distinct_frames(torch, frame, size):
    """How many blocks of ``size`` consecutive rays hold 1, 2 and 3
    distinct shear frames."""
    pad = (-frame.numel()) % size
    f = torch.cat([frame, frame[-1:].expand(pad)]).reshape(-1, size)
    seen = torch.stack([(f == a).any(dim=1) for a in range(3)]).sum(0)
    return torch.bincount(seen, minlength=4)[1:].tolist()


def _rows_stats(torch, trw, ch, lists, o, d, t, skip, out):
    """The row-union closest walk's work on a wave: list entries per row
    (mean, max), the share of entries whose block-wide decision walks the
    chunk, the real rows and the rows to the last real one of the walked
    chunks, distinct shear frames per 128-ray row and per 32-ray warp, dead
    lanes (t_max <= 0 or NaN) and warps whose 32 lanes are all dead.  The
    walked chunks are those ROOT's plain walk hands to ``_chunk_groups``;
    that walk must give the kernel's output ``out``."""
    k = ch.leaf_size
    walked = []
    groups = trw._chunk_groups

    def spy(ch_, tt):
        walked.append(tt)
        return groups(ch_, tt)

    trw._chunk_groups = spy
    try:
        ref = trw.rows_closest_walk_plain(ch, lists, o, d, t, skip=skip)
    finally:
        trw._chunk_groups = groups
    if not PROBING and not torch.equal(ref, out):
        raise RuntimeError("rows_closest: the plain walk differs")
    pid = ch.rows[:, 10].reshape(-1, k)
    real = (pid >= 0.0).sum(dim=1)
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1, device=pid.device),
                       0).amax(dim=1)
    tt = torch.cat(walked).long() if walked else lists.new_zeros(0).long()
    entries = (lists >= 0).sum(dim=1)
    frame = shear_frames(torch, d)
    dead = ~(t > 0.0)
    return dict(rows=int(lists.shape[0]),
                entries_mean=float(entries.float().mean()),
                entries_max=int(entries.max()),
                walked_share=int(tt.numel()) / max(1, int(entries.sum())),
                walked_real_rows=float(real[tt].float().mean()),
                walked_last_real_row=float(last[tt].float().mean()),
                frames_per_row=distinct_frames(torch, frame, 128),
                frames_per_warp=distinct_frames(torch, frame, 32),
                dead_lanes=int(dead.sum()),
                dead_warps=int(dead.reshape(-1, 32).all(dim=1).sum()),
                pad_not_tail=int((last != real).sum()))


def _dense_stats(torch, ttr, tris, o, d, t, light, skip, out, threads=256):
    """The dense closest sweep's work on a wave: the share of its tests
    (every lane against every triangle) that pass the sign, det and range
    tests (the divides a test takes only on a pass) and the share that
    take the hit, distinct shear frames per block of ``threads`` rays and
    dead lanes; from a plain sweep with watertight's operations, which must
    give the kernel's t."""
    ox, oy, oz, dx, dy, dz = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                              d[:, 2])
    pre = ttr.ray_shear(dx, dy, dz)
    tc = t.clone()
    passes = takes = torch.zeros((), dtype=torch.int64, device=t.device)
    for i, row in enumerate(tris[:, :9].unbind(0)):
        hit, ti, _, _ = ttr.watertight(ox, oy, oz, dx, dy, dz, tc,
                                       row.unbind(0), pre)
        closer = hit & (ti < tc)
        if skip is not None:
            closer = closer & (light[i] != skip)
        passes = passes + hit.sum()
        takes = takes + closer.sum()
        tc = torch.where(closer, ti, tc)
    if not PROBING and not torch.equal(tc, out[0]):
        raise RuntimeError("dense_closest: the plain sweep differs")
    tests = t.numel() * tris.shape[0]
    return dict(rays=int(t.numel()), triangles=int(tris.shape[0]),
                pass_share=int(passes) / max(1, tests),
                take_share=int(takes) / max(1, tests),
                frames_per_block=distinct_frames(
                    torch, shear_frames(torch, d), threads),
                dead_lanes=int((~(t > 0.0)).sum()))


def _hits_digest(torch, out):
    """One digest of a closest query's (t, prim, b0, b1)."""
    return digest(torch.cat([x.reshape(-1).view(torch.int32) for x in out]))


def _shade_class(torch, tsf, tb, rh, prim):
    """Each lane's class for the shade kernel: 0 dead (not alive and
    hit), else 1 + 2 mtype + 1 on a sphere's surface, from the wave's
    tables as select_rows reads them."""
    alive = rh[tsf._RH["alive"]] > 0.0
    sph = rh[tsf._RH["sph"]]
    mid = tb.trs[prim.clamp(min=0).long(), 26]
    on_sphere = torch.zeros_like(alive)
    if tb.n_spheres:
        si = sph.clamp(0, tb.n_spheres - 1).long()
        on_sphere = (sph >= 0.0) & (sph < tb.n_spheres) & (si.float() == sph)
        mid = torch.where(on_sphere, tb.sp[si, 34], mid)
    mtype = tb.mat[mid.clamp(min=0.0).long(), 0].long().clamp(0, 3)
    return torch.where(alive, 1 + 2 * mtype + on_sphere.long(), 0)


def _warp_classes(torch, cls, size=32):
    """How many groups of ``size`` consecutive lanes hold 1, 2, ...
    N_CLASSES distinct classes."""
    pad = (-cls.numel()) % size
    c = torch.cat([cls, cls[-1:].expand(pad)]).reshape(-1, size)
    seen = torch.stack([(c == k).any(dim=1) for k in range(N_CLASSES)]).sum(0)
    return torch.bincount(seen, minlength=N_CLASSES + 1)[1:].tolist()


def _shade(torch, tsf, res, tag, ms, cases):
    """The shade kernel on the lanes path_li handed it at each bounce of
    a first wave: its output's digest, a call's time and the kernel's
    device time; the same lanes permuted by class (the outputs permuted
    back must keep their bits) and their device time; the share of dead
    lanes, the lanes by class and the warps by distinct classes."""
    for what, calls in cases:
        for args in calls:
            tb, rh, prim, ph, texp, dim0, bounce = args[:7]
            spl = args[7] if len(args) > 7 else None

            def fn():
                return tsf.shade_planes(tb, rh, prim, ph, texp, dim0, bounce,
                                        spl)
            out = fn()
            key = f"shade {what} bounce {bounce}"
            res["hashes"][key] = digest(out)
            t_k = ms(fn)
            t_dev = kernel_device_ms(torch, fn, "shade_kernel")
            cls = _shade_class(torch, tsf, tb, rh, prim)
            perm = torch.argsort(cls, stable=True)
            inv = torch.argsort(perm)

            def cols(x):
                return None if x is None else x[..., perm].contiguous()
            p_args = (cols(rh), cols(prim), cols(ph), cols(texp))

            def fn_sorted():
                return tsf.shade_planes(tb, *p_args, dim0, bounce, cols(spl))
            out_p = fn_sorted()
            torch.cuda.synchronize()
            if not PROBING and not torch.equal(
                    out_p[:, inv].view(torch.int32), out.view(torch.int32)):
                print(f"chip_ab: FAIL: {key}: permuted lanes give other "
                      "bits", file=sys.stderr)
                return 1
            t_sorted = kernel_device_ms(torch, fn_sorted, "shade_kernel")
            n = int(cls.numel())
            counts = torch.bincount(cls, minlength=N_CLASSES).tolist()
            warps = _warp_classes(torch, cls)
            mean_distinct = sum((k + 1) * w for k, w in enumerate(warps)) / max(
                1, sum(warps))
            res["ms"][key] = t_k
            res["ms"][f"{key}: kernel device time"] = t_dev
            res["ms"][f"{key}, lanes by class: kernel device time"] = t_sorted
            res["notes"][key] = dict(
                lanes=n, dead_share=counts[0] / max(1, n), classes=counts,
                warps_by_distinct_classes=warps,
                mean_distinct_classes=mean_distinct,
                strat=spl is not None)
            print(f"[{tag}] {key} [{n} lanes, dead {counts[0] / max(1, n):.4f}"
                  f", classes {counts}, warps by distinct classes {warps} "
                  f"(mean {mean_distinct:.3f})]: {t_k:.4f} ms a call, kernel "
                  f"device time {t_dev:.4f} ms; lanes by class "
                  f"{t_sorted:.4f} ms ({t_sorted / max(t_dev, 1e-9):.3f}x)")
    return 0


def _any_dense_stats(torch, ttr, tris, light, o, d, t, skip, occ,
                     threads=256):
    """The dense occlusion sweep's work on a wave: of the lanes with
    t_max > 0, the share occluded, the mean triangles each tests up to
    and including its first occluder (all when none), the same without
    the triangles of the lane's skip light, and over the occluded lanes
    alone; shear frames per block of ``threads`` rays; from a plain sweep
    with watertight's operations, which must give the kernel's
    occlusion."""
    ox, oy, oz, dx, dy, dz = (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                              d[:, 2])
    pre = ttr.ray_shear(dx, dy, dz)
    n_tris = tris.shape[0]
    found = torch.zeros_like(t, dtype=torch.bool)
    first = torch.full_like(t, n_tris, dtype=torch.int64)
    skipped = torch.zeros_like(t, dtype=torch.int64)
    for i, row in enumerate(tris[:, :9].unbind(0)):
        mine = light[i] == skip
        skipped = skipped + (mine & ~found).long()
        hit = ttr.watertight(ox, oy, oz, dx, dy, dz, t, row.unbind(0), pre)[0]
        blocked = hit & ~mine & ~found
        first = torch.where(blocked, i + 1, first)
        found = found | blocked
    if not PROBING and not torch.equal(found, occ):
        raise RuntimeError("dense_any: the plain sweep differs")
    live = t > 0.0
    n_live = max(1, int(live.sum()))
    lo = live & found

    def mean(x, m):
        return float(x[m].float().mean()) if int(m.sum()) else 0.0
    return dict(rays=int(t.numel()), triangles=n_tris, live=int(live.sum()),
                occluded_share=int(lo.sum()) / n_live,
                tests_to_first=mean(first, live),
                tests_to_first_without_skip=mean(first - skipped, live),
                tests_to_first_occluded=mean(first, lo),
                frames_per_block=distinct_frames(
                    torch, shear_frames(torch, d), threads))


def _dense(torch, sm, res, tag, ms, any_calls):
    """The dense sweeps (see the module's docstring); ``any_calls``: the
    arguments of path_li's first two occlusion queries on Cornell."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.integrators import PathParams, _ph_i32
    from yuki_tpu_torch.ops import shade_fused as tsf
    from yuki_tpu_torch.ops import trace as ttr
    from yuki_tpu_torch.ops.trace import F32_MAX, pack_triangles
    from yuki_tpu_torch.scene.cornell import cornell

    dev = torch.device("cuda")
    scene, cam, _ = cornell(device=dev)
    data = scene.data
    ctx, o, d = sm._camera_wave(torch, dev, cam, CORNELL_TILES)
    t_max = torch.full((o.shape[0],), F32_MAX, device=dev)
    tris = pack_triangles(data.tris.p0, data.tris.p1, data.tris.p2)
    light = data.tris.area_light
    hit = traverse.intersect(data, scene.meta, o, d, t_max, skip_sort=True)
    out0 = tsf.shade_fused(tsf.make_shade_tables(scene, PathParams(DEPTH)),
                           hit, o, d, torch.ones_like(o), hit.hit,
                           torch.zeros_like(hit.hit), _ph_i32(ctx), 2, 0)
    t1 = torch.where(out0[3], F32_MAX, 0.0).to(torch.float32)
    co, cd, ct, cs = sm._combine(torch, o, d, t_max, *out0[5:9])
    soup, soup_light, so, sd, st_, soup_skip = sm._soup(torch, dev)
    cases = (("Cornell camera wave", tris, o, d, t_max, None),
             ("Cornell bounce-1 rays", tris, out0[0], out0[1], t1, None),
             (f"{soup.shape[0]}-triangle soup", soup, so, sd, st_, None),
             ("Cornell combined wave", tris, co, cd, ct, cs),
             ("Cornell combined wave, without skip", tris, co, cd, ct, None))
    for what, tp, ro, rd, rt, sk in cases:
        if sk is None:
            def fn():
                return ttr.dense_trace(tp, ro, rd, rt)
        else:
            def fn():
                return ttr.dense_trace_skip(tp, light, ro, rd, rt, sk)
        name = "dense_closest" if sk is None else "dense_closest_skip"
        out = fn()
        res["hashes"][f"{name} {what}"] = _hits_digest(torch, out)
        t_k = ms(fn)
        t_dev = kernel_device_ms(torch, fn, "dense_closest_kernel")
        res["ms"][f"{name} {what}"] = t_k
        res["ms"][f"{name} {what}: kernel device time"] = t_dev
        st = _dense_stats(torch, ttr, tp, ro, rd, rt, light, sk, out)
        res["notes"][f"{name} {what}"] = st
        print(f"[{tag}] {name} [{what}: {st['rays']} rays, {st['dead_lanes']}"
              f" dead, {st['triangles']} triangles; tests passing sign, det "
              f"and range {st['pass_share']:.5f}, taking the hit "
              f"{st['take_share']:.5f}; 256-ray blocks by distinct frames "
              f"(1, 2, 3) {st['frames_per_block']}]: {t_k:.4f} ms a call, "
              f"kernel device time {t_dev:.4f} ms")

    any_cases = [("Cornell bounce-0 shadow rays", any_calls[0]),
                 ("Cornell bounce-1 shadow rays", any_calls[1]),
                 (f"{soup.shape[0]}-triangle soup",
                  (soup, soup_light, so, sd, st_, soup_skip))]
    for what, (tp, lt, ro, rd, rt, sk) in any_cases:
        def fn():
            return ttr.any_trace(tp, lt, ro, rd, rt, sk)
        out = fn()
        res["hashes"][f"dense_any {what}"] = digest(out)
        t_k = ms(fn)
        t_dev = kernel_device_ms(torch, fn, "dense_any_kernel")
        res["ms"][f"dense_any {what}"] = t_k
        res["ms"][f"dense_any {what}: kernel device time"] = t_dev
        st = _any_dense_stats(torch, ttr, tp, lt, ro, rd, rt, sk, out)
        res["notes"][f"dense_any {what}"] = st
        print(f"[{tag}] dense_any [{what}: {st['rays']} rays, {st['live']} "
              f"with t_max > 0, {st['triangles']} triangles; occluded "
              f"{st['occluded_share']:.4f} of them; triangles to the first "
              f"occluder {st['tests_to_first']:.2f} ("
              f"{st['tests_to_first_without_skip']:.2f} without the skip "
              f"light's, {st['tests_to_first_occluded']:.2f} on occluded "
              f"lanes); 256-ray blocks by distinct frames (1, 2, 3) "
              f"{st['frames_per_block']}]: {t_k:.4f} ms a call, kernel "
              f"device time {t_dev:.4f} ms")


def _rows(torch, sm, res, tag, scene, wave0, ms, closest=True):
    """The row-union walks (see the module's docstring); ``closest``
    False: the occlusion walk alone."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_rows as trw

    ch = scene.data.chunks
    o, d, t_max = wave0[:3]
    no, nd, nt, sk = wave0[3:7]
    lists, _ = trw.kept_lists(trw.row_words_interval(ch, no, nd, nt),
                              traverse._ROWS_C, traverse._ROWS_MULT)
    skf = sk.to(torch.float32).contiguous()

    def fn_any():
        return trw.rows_any_walk(ch, lists, no, nd, nt, skf)
    what = "forced bounce-0 shadow rays"
    out = fn_any()
    res["hashes"][f"rows_any {what}"] = digest(out)
    t_k = ms(fn_any)
    t_dev = kernel_device_ms(torch, fn_any, "rows_any_kernel")
    res["ms"][f"rows_any {what}"] = t_k
    res["ms"][f"rows_any {what}: kernel device time"] = t_dev
    if not PROBING:
        st = _rows_any_stats(torch, trw, ch, lists, no, nd, nt, skf, out)
        res["notes"][f"rows_any {what}"] = st
        print(f"[{tag}] rows_any [{what}: {no.shape[0]} rays, {st['rows']} "
              f"rows, {st['dead_rows']} with no live lane; list entries "
              f"{st['entries']}, walked {st['walked']}; groups a walked "
              f"chunk's row walks (G + 1) mean {st['groups_walked_mean']:.3f}"
              f" against {st['last_groups_mean']:.3f} to its last real row "
              f"({ch.leaf_size // 8} in all); rows a walking lane tests "
              f"{st['lane_rows_mean']:.2f} (the first port: every lane "
              f"8 (G + 1)); non-crossing live lanes entering walked chunks "
              f"unoccluded {st['noncross_entered']}, occluded there "
              f"{st['noncross_occluded_share']:.4f}; barriers a list entry "
              f"{st['barriers_parent']:.3f} (first port) and "
              f"{st['barriers_new']:.3f} (redesign); rows by walked entries "
              f"{st['walked_per_row_bins']}, at most "
              f"{st['walked_per_row_max']} walked and "
              f"{st['entries_per_row_max']} listed a row, the five most "
              f"walked (row, entries, walked) {st['top_rows']}; "
              f"{int(out.sum())} occluded]: {t_k:.4f} ms a call, kernel "
              f"device time {t_dev:.4f} ms")
    else:
        print(f"[{tag}] rows_any [{what}]: {t_k:.4f} ms a call, kernel "
              f"device time {t_dev:.4f} ms")
    if not closest:
        return 0
    co, cd, ct, cs = sm._sort_rays(torch, scene.data,
                                   *sm._combine(torch, *wave0))
    cases = (("camera rays", o, d, t_max, None),
             ("sorted combined wave", co, cd, ct, cs.to(torch.float32)),
             ("sorted combined wave, without skip", co, cd, ct, None))
    for what, ro, rd, rt, sk in cases:
        lists, _ = trw.kept_lists(trw.row_words_interval(ch, ro, rd, rt),
                                  traverse._ROWS_C, traverse._ROWS_MULT)

        def fn():
            return trw.rows_closest_walk(ch, lists, ro, rd, rt, sk)
        name = "rows_closest" if sk is None else "rows_closest_skip"
        out = fn()
        res["hashes"][f"{name} {what}"] = digest(out)
        t_k = ms(fn)
        t_dev = kernel_device_ms(torch, fn, "rows_closest_kernel")
        res["ms"][f"{name} {what}"] = t_k
        res["ms"][f"{name} {what}: kernel device time"] = t_dev
        st = _rows_stats(torch, trw, ch, lists, ro, rd, rt, sk, out)
        res["notes"][f"{name} {what}"] = st
        print(f"[{tag}] {name} [{what}: {ro.shape[0]} rays, {st['rows']} "
              f"rows; list entries a row mean {st['entries_mean']:.2f}, max "
              f"{st['entries_max']}; walked {st['walked_share']:.4f} of them;"
              f" walked chunks' real rows {st['walked_real_rows']:.2f}, to "
              f"the last real {st['walked_last_real_row']:.2f} of "
              f"{ch.leaf_size} ({st['pad_not_tail']} chunks whose padding is "
              f"not a tail); rows by distinct frames (1, 2, 3) "
              f"{st['frames_per_row']}, warps {st['frames_per_warp']}; "
              f"{st['dead_lanes']} dead lanes, {st['dead_warps']} dead "
              f"warps]: {t_k:.4f} ms a call, kernel device time "
              f"{t_dev:.4f} ms")


def _rows_any_stats(torch, trw, ch, lists, o, d, t, skip, out):
    """The occlusion row walk's work on a wave, from a plain walk with the
    plain version's tests that must give the kernel's occlusion ``out``:
    per list entry, the rows that walk the chunk (some lane of S crosses
    it unoccluded); per walked chunk, G + 1 (the groups the row walks, as
    the TPU kernel and the first port do) against the groups up to the
    chunk's last real row; the rows each live, unoccluded lane tests up to
    its first occluder or the last real row (the redesign's walk); of the
    live lanes that do not cross a walked chunk and enter it unoccluded,
    the share the walk occludes; rows with no live lane; barriers per list
    entry: the first port's vote, stage and one vote a group walked, the
    redesign's vote, stage and G's reduction."""
    from yuki_tpu_torch.ops.trace import ray_shear, watertight_scaled

    k = ch.leaf_size
    ox, oy, oz, dx, dy, dz, tm = trw._row_planes(o, d, t)
    sk = skip.reshape(tm.shape)
    pre = ray_shear(dx, dy, dz)
    live = tm > 0.0
    ones = torch.ones_like(tm)
    occ = torch.zeros_like(live)
    pid = ch.rows[:, 10].reshape(-1, k)
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1, device=pid.device),
                       0).amax(dim=1)
    acc = dict(entries=0, walked=0, groups_walked=0, last_groups=0,
               lane_rows=0, walkers=0, noncross_entered=0,
               noncross_occluded=0, barriers_parent=0, barriers_new=0)
    walked_row = torch.zeros(tm.shape[0], dtype=torch.int64, device=o.device)
    for j in range(lists.shape[1]):
        tt = lists[:, j].long()
        on = tt >= 0
        n_on = int(on.sum())
        if not n_on:
            break
        cb = ch.treelet_bounds[tt.clamp(min=0)]
        crossing = live & trw._recheck(cb, ox, oy, oz, dx, dy, dz, tm, ones)
        in_s = crossing & ~occ
        r = torch.nonzero(on & in_s.any(dim=1)).squeeze(1)
        acc["entries"] += n_on
        acc["barriers_parent"] += n_on
        acc["barriers_new"] += n_on
        if r.numel() == 0:
            continue
        lane = [x[r] for x in (ox, oy, oz)]
        pre_r = tuple(x[r] for x in pre)
        tm_r, sk_r = tm[r], sk[r]
        first = torch.full_like(tm_r, k, dtype=torch.int64)
        groups = trw._chunk_groups(ch, tt[r])
        for g in range(groups.shape[1]):
            cols = trw._group_cols(groups[:, g])
            ok, ts_c, det_c = watertight_scaled(pre_r, *lane, cols[:9])
            blocked = (ok & (ts_c <= tm_r * det_c) & (cols[9] != sk_r)
                       & (cols[10] >= 0.0))
            idx = torch.arange(8 * g, 8 * g + 8, device=o.device)[:, None,
                                                                  None]
            first = torch.minimum(first, torch.where(blocked, idx, k).amin(0))
        found = first < k
        grp = torch.where(found, first // 8, k // 8 - 1)
        G = torch.where(in_s[r], grp, -1).amax(dim=1)
        walker = live[r] & ~occ[r]
        new = walker & found & (first // 8 <= G[:, None])
        lim = last[tt[r]]
        nc = walker & ~crossing[r]
        acc["walked"] += int(r.numel())
        walked_row[r] += 1
        acc["groups_walked"] += int((G + 1).sum())
        acc["last_groups"] += int(((lim + 7) // 8).sum())
        acc["lane_rows"] += int(torch.where(walker, torch.minimum(
            first + 1, lim[:, None]), 0).sum())
        acc["walkers"] += int(walker.sum())
        acc["noncross_entered"] += int(nc.sum())
        acc["noncross_occluded"] += int((nc & new).sum())
        acc["barriers_parent"] += int(r.numel() + (G + 1).sum())
        acc["barriers_new"] += 2 * int(r.numel())
        occ[r] = occ[r] | new
    if not torch.equal(occ.reshape(-1).to(torch.int32), out):
        raise RuntimeError("rows_any: the plain walk's occlusion differs")
    w = max(1, acc["walked"])
    entries = (lists >= 0).sum(dim=1)
    top = torch.argsort(walked_row, descending=True)[:5]
    bins = torch.tensor([0, 1, 2, 4, 8, 16, 32, 1 << 30], device=o.device)
    return dict(rows=int(tm.shape[0]), dead_rows=int((~live.any(dim=1)).sum()),
                entries_per_row_max=int(entries.max()),
                walked_per_row_max=int(walked_row.max()),
                walked_per_row_bins=dict(zip(
                    ["0", "1", "2-3", "4-7", "8-15", "16-31", "32+"],
                    [int(((walked_row >= lo) & (walked_row < hi)).sum())
                     for lo, hi in zip(bins[:-1], bins[1:])])),
                top_rows=[(int(x), int(entries[x]), int(walked_row[x]))
                          for x in top],
                entries=acc["entries"], walked=acc["walked"],
                groups_walked_mean=acc["groups_walked"] / w,
                last_groups_mean=acc["last_groups"] / w,
                lane_rows_mean=acc["lane_rows"] / max(1, acc["walkers"]),
                noncross_entered=acc["noncross_entered"],
                noncross_occluded_share=acc["noncross_occluded"] / max(
                    1, acc["noncross_entered"]),
                barriers_parent=acc["barriers_parent"] / max(1, acc["entries"]),
                barriers_new=acc["barriers_new"] / max(1, acc["entries"]))


def _wave_stats(torch, tpf, tb, px, py, si, spl, tile=512):
    """The wave's work from the two-kernel wave's state: the live lanes
    entering each bounce and, at each bounce, the 32-lane warps with a
    live lane by their distinct classes among live lanes, in film order
    and in the order of ``tile``-lane tiles sorted by class, dead lanes
    dropped; with the mean distinct classes a warp of each order."""
    st, ph = tpf.raygen_trace(px, py, si, 1, tb,
                              None if spl is None else spl[:2])
    out = []
    for b in range(tb.max_depth):
        cls = material_class(torch, tpf, tb, st)
        live = cls > 0
        n = int(cls.numel())
        pad = (-n) % tile
        c = torch.cat([cls, cls.new_zeros(pad)]).reshape(-1, tile)
        # Film order: each warp's live lanes.
        film = c.reshape(-1, 32)
        # Tile order: live lanes sorted by class, packed to the front.
        key = torch.where(c > 0, c, N_CLASSES + 1)
        srt = torch.sort(key, dim=1, stable=True).values
        srt = torch.where(srt > N_CLASSES, 0, srt).reshape(-1, 32)

        def by_distinct(w):
            seen = torch.stack([(w == k).any(dim=1) for k in
                                range(1, N_CLASSES + 1)]).sum(0)
            counts = torch.bincount(seen[seen > 0], minlength=N_CLASSES + 1)
            counts = counts[1:].tolist()
            mean = sum((i + 1) * x for i, x in enumerate(counts)) / max(
                1, sum(counts))
            return counts, mean
        f_counts, f_mean = by_distinct(film)
        s_counts, s_mean = by_distinct(srt)
        out.append(dict(bounce=b, live=int(live.sum()),
                        film_warps=f_counts, film_mean=f_mean,
                        tile_warps=s_counts, tile_mean=s_mean))
        st = tpf.bounce(st, ph, b, tb, tpf._bounce_planes(spl, tb, b))
    return out


def _wave(torch, tpf, res, tag, ms, tb, px, py):
    """The one-kernel wave (see the module's docstring)."""
    from yuki_tpu_torch.sampling import StratifiedSampler

    for sam_name, sam, si in (("uniform", None, 0),
                              ("strat", StratifiedSampler(4, 4), 5)):
        spl = tpf.strat_planes(sam, px, py, si, 1, tb.n_lights, DEPTH)

        def one():
            return tpf.wave(px, py, si, 1, tb, spl)

        def two():
            st, ph = tpf.raygen_trace(px, py, si, 1, tb,
                                      None if spl is None else spl[:2])
            for b in range(DEPTH):
                st = tpf.bounce(st, ph, b, tb, tpf._bounce_planes(spl, tb, b))
            return st[[tpf._ST[k] for k in ("rx", "ry", "rz", "rc")]]
        got = one()
        res["hashes"][f"wave {sam_name}"] = digest(got)
        if not PROBING:
            ref = two()
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                print(f"chip_ab: FAIL: wave {sam_name}: bits differ from the "
                      "two-kernel wave", file=sys.stderr)
                return 1
        key = f"wave {sam_name}"
        res["ms"][key] = ms(one, 10)
        res["ms"][f"{key}: kernel device time"] = kernel_device_ms(
            torch, one, "wave_kernel", 5)
        res["ms"][f"two-kernel {key}"] = ms(two, 10)
        res["ms"][f"two-kernel {key}: kernel device time"] = sum(
            kernel_device_ms(torch, two, name, 5)
            for name in ("raygen_trace_kernel", "bounce_kernel"))
        note = ""
        if not PROBING:
            st = _wave_stats(torch, tpf, tb, px, py, si, spl)
            res["notes"][key] = st
            note = "; " + "; ".join(
                f"bounce {x['bounce']}: {x['live']} live, warps by distinct "
                f"classes film order {x['film_warps'][:4]} (mean "
                f"{x['film_mean']:.3f}), tiles sorted {x['tile_warps'][:4]} "
                f"(mean {x['tile_mean']:.3f})" for x in st)
        print(f"[{tag}] {key} [{px.shape[0]} lanes]: "
              f"{res['ms'][key]:.4f} ms a call, kernel device time "
              f"{res['ms'][f'{key}: kernel device time']:.4f} ms; two-kernel "
              f"wave {res['ms'][f'two-kernel {key}']:.4f} ms a call, its "
              f"kernels' device time "
              f"{res['ms'][f'two-kernel {key}: kernel device time']:.4f} ms"
              f"{note}")
    return 0


def _walker_stats(torch, tw, ch, lists, o, d, t, skip, out, closest):
    """The bundle walk's work on a wave, from a plain walk with the plain
    version's decisions (ROOT's helpers) that must give the kernel's
    output ``out`` (closest: (t, prim); occlusion: the bits): list
    entries and the entries walked (some ray live), live rays a walked
    entry, the real rows and the rows to the last real one of the walked
    chunks, rechecks and triangle tests, bundles with an empty list and
    bundles by distinct shear frames among their rays with t_max > 0 (0
    to 3); closest: the walked entries after which some slot took a hit;
    occlusion: the listed entries met with all 8 rays dead or occluded."""
    from yuki_tpu_torch.ops.trace import ray_shear, watertight_scaled

    bun, k = 8, ch.leaf_size
    n_b = lists.shape[0]
    pid = ch.rows[:, 10].reshape(-1, k)
    real = (pid >= 0.0).sum(dim=1)
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1, device=pid.device),
                       0).amax(dim=1)
    acc = dict.fromkeys(("entries", "walked", "live", "real_rows",
                         "last_rows", "boxes", "tests", "took", "spent"), 0)
    got = [torch.empty_like(t), torch.empty_like(t, dtype=torch.int32)]
    for a in range(0, n_b, 8192):
        b = min(a + 8192, n_b)
        ox, oy, oz, dx, dy, dz, tm = tw._bundle_planes(o, d, t, a, b)
        sk = None if skip is None else skip[a * bun:b * bun].reshape(b - a,
                                                                     bun)
        ts_ = tm[:, :, None].expand(b - a, bun, 128).clone()
        det = torch.ones_like(ts_)
        prim = torch.full_like(ts_, -1.0)
        occ = torch.zeros_like(tm, dtype=torch.bool)
        for j in range(lists.shape[1]):
            tt = lists[a:b, j].long()
            on = tt >= 0
            if not bool(on.any()):
                break
            open_ = (tm > 0.0) & ~occ
            bnd = (ts_ / det).amin(dim=2) if closest else tm
            live = open_ & on[:, None] & tw._bounds_recheck(
                ch.treelet_bounds[tt.clamp(min=0)], ox, oy, oz, dx, dy, dz,
                bnd)
            r = torch.nonzero(live.any(dim=1)).squeeze(1)
            acc["entries"] += int(on.sum())
            acc["boxes"] += int(((tm > 0.0) & on[:, None]).sum())
            acc["spent"] += int((on & ~open_.any(dim=1)).sum())
            acc["walked"] += int(r.numel())
            acc["live"] += int(live.sum())
            acc["real_rows"] += int(real[tt[r]].sum())
            acc["last_rows"] += int(last[tt[r]].sum())
            acc["tests"] += int((live[r].sum(dim=1) * real[tt[r]]).sum())
            if r.numel() == 0:
                continue
            cols = tw._chunk_cols(ch, tt[r])
            ray = [x[r][:, :, None] for x in (ox, oy, oz, dx, dy, dz)]
            ok, ts_c, det_c = watertight_scaled(ray_shear(*ray[3:]), *ray[:3],
                                                cols[:9])
            lv = live[r][:, :, None] & (cols[10] >= 0.0)
            if sk is not None:
                lv = lv & (cols[9] != sk[r][:, :, None])
            if not closest:
                occ[r] = occ[r] | (ok & lv & (ts_c <= tm[r][:, :, None]
                                              * det_c)).any(dim=2)
                continue
            ts_b, det_b, prim_b = ts_[r, :, :k], det[r, :, :k], prim[r, :, :k]
            closer = ok & lv & (ts_c * det_b < ts_b * det_c)
            acc["took"] += int(closer.flatten(1).any(dim=1).sum())
            ts_[r, :, :k] = torch.where(closer, ts_c, ts_b)
            det[r, :, :k] = torch.where(closer, det_c, det_b)
            prim[r, :, :k] = torch.where(closer, cols[10].expand_as(ts_c),
                                         prim_b)
        sl = slice(a * bun, b * bun)
        if closest:
            t_b, p_b = tw._fold_closest(ts_, det, prim, tm)
            got[0][sl], got[1][sl] = t_b.reshape(-1), p_b.reshape(-1)
        else:
            got[1][sl] = occ.reshape(-1).to(torch.int32)
    same = (all(torch.equal(g, x) for g, x in zip(got, out)) if closest
            else torch.equal(got[1], out))
    if not PROBING and not same:
        raise RuntimeError("walker: the plain walk differs from the kernel")
    frame = shear_frames(torch, d).reshape(n_b, bun)
    alive = (t > 0.0).reshape(n_b, bun)
    distinct = torch.stack([((frame == f) & alive).any(dim=1)
                            for f in range(3)]).sum(0)
    w = max(1, acc["walked"])
    return dict(acc, bundles=n_b, empty=int((lists[:, 0] < 0).sum()),
                walked_share=acc["walked"] / max(1, acc["entries"]),
                live_per_walked=acc["live"] / w,
                real_rows_mean=acc["real_rows"] / w,
                last_rows_mean=acc["last_rows"] / w,
                took_share=acc["took"] / w,
                frames_per_bundle=torch.bincount(distinct,
                                                 minlength=4).tolist())


def _walker(torch, sm, res, tag, scene, bounce1, shadow, wave0, ms):
    """The bundle walks (see the module's docstring)."""
    from yuki_tpu_torch.ops import trace_stream as ts
    from yuki_tpu_torch.ops import trace_walker as tw

    ch = scene.data.chunks
    co, cd, ct, cs = sm._combine(torch, *bounce1, *shadow)
    no, nd, nt, sk = wave0
    f32 = torch.float32
    cases = (("walker_closest", "bounce-1 rays", bounce1, None),
             ("walker_closest_skip", "combined wave", (co, cd, ct),
              cs.to(f32)),
             ("walker_closest", "combined wave, without skip", (co, cd, ct),
              None),
             ("walker_any", "bounce-0 shadow rays", (no, nd, nt),
              sk.to(f32).contiguous()))
    for name, what, (ro, rd, rt), skf in cases:
        lists, _ = tw.walker_lists(ts.cross_words(ch, ro, rd, rt), tw.C_WALK)
        closest = name != "walker_any"
        if closest:
            def fn():
                return tw.walker_closest_walk(ch, lists, ro, rd, rt, skf)
        else:
            def fn():
                return tw.walker_any_walk(ch, lists, ro, rd, rt, skf)
        out = fn()
        key = f"{name} {what}"
        res["hashes"][key] = (digest(torch.cat([out[0].view(torch.int32),
                                                out[1]]))
                              if closest else digest(out))
        t_k = ms(fn, 10)
        t_dev = kernel_device_ms(torch, fn, "walker_closest_kernel" if closest
                                 else "walker_any_kernel")
        res["ms"][key] = t_k
        res["ms"][f"{key}: kernel device time"] = t_dev
        st = _walker_stats(torch, tw, ch, lists, ro, rd, rt, skf, out,
                           closest)
        res["notes"][key] = st
        extra = (f"entries after which a slot took a hit {st['took']} "
                 f"({st['took_share']:.4f} of the walked)" if closest else
                 f"entries met with all 8 rays dead or occluded "
                 f"{st['spent']}; {int(out.sum())} occluded")
        print(f"[{tag}] {key} [{ro.shape[0]} rays, {st['bundles']} bundles, "
              f"{st['empty']} with an empty list, by distinct shear frames "
              f"of their live rays (0-3) {st['frames_per_bundle']}; list "
              f"entries {st['entries']}, walked {st['walked']} "
              f"({st['walked_share']:.4f}), live rays a walked entry "
              f"{st['live_per_walked']:.3f}; walked chunks' real rows "
              f"{st['real_rows_mean']:.2f}, to the last real "
              f"{st['last_rows_mean']:.2f} of {ch.leaf_size}; {st['boxes']} "
              f"rechecks, {st['tests']} triangle tests; {extra}]: "
              f"{t_k:.4f} ms a call, kernel device time {t_dev:.4f} ms")
    return 0


def _any_stats(torch, ch, row_chunk, stream, occ):
    """The occlusion slot walk's work on its slots: the share of live
    slots that end occluded, the mean rows an occluded slot tests up to
    and including its first occluder (padding rows counted), and the mean
    real rows and rows to the last real row of the unoccluded slots'
    chunks; from a plain torch walk over the rows, which must give the
    kernel's occlusion."""
    from yuki_tpu_torch.ops.trace import ray_shear, watertight_scaled

    k = ch.leaf_size
    tri = ch.rows.reshape(-1, k, ch.rows.shape[1])
    lanes = torch.nonzero(stream[:, 6] > 0.0).squeeze(1)
    ray = stream[lanes]
    chunk = row_chunk.long()[lanes // 128]
    ox, oy, oz, dx, dy, dz, t0, skip = (ray[:, j] for j in range(8))
    pre = ray_shear(dx, dy, dz)
    first = torch.full_like(chunk, k)
    for r in range(k):
        c = tri[chunk, r]
        ok, ts_, det = watertight_scaled(pre, ox, oy, oz,
                                         [c[:, j] for j in range(9)])
        blocked = ok & (ts_ <= t0 * det) & (c[:, 9] != skip) & (
            c[:, 10] >= 0.0)
        first = torch.where(blocked & (first == k), r, first)
    hit = first < k
    if not torch.equal(hit.to(torch.int32), occ[lanes]):
        raise RuntimeError("slot_any: the plain walk's occlusion differs")
    pid = tri[:, :, 10]
    real = (pid >= 0.0).sum(dim=1)[chunk]
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1, device=pid.device),
                       0).amax(dim=1)[chunk]
    n_live, n_occ = int(lanes.numel()), int(hit.sum())

    def mean(x):
        return float(x.float().mean()) if x.numel() else 0.0

    return dict(live_slots=n_live, occluded_share=n_occ / max(1, n_live),
                rows_to_first_occluder=mean(first[hit] + 1),
                unoccluded_real_rows=mean(real[~hit]),
                unoccluded_rows_to_last_real=mean(last[~hit]))


def _crossed_word_stats(torch, ts, ch, o, d, t):
    """Crossed word boxes per live ray (mean, median, 90th percentile,
    max) and, over 32-ray groups in wave order (one thread-per-ray warp),
    the sum of their union sizes times 32 against the sum of the rays'
    own counts: the level-2 chunk tests of a warp that walks every word
    any of its rays crosses against those of one that walks each ray's
    own."""
    wb = ts.word_boxes(ch.treelet_bounds, ch.n_treelets, float("inf"))
    crossed = ts.box_crossings(wb[:, 0:3], wb[:, 3:6], o, d, t)
    per_ray = crossed.sum(dim=1)
    live = per_ray[t > 0.0].float()
    pad = (-crossed.shape[0]) % 32
    groups = torch.cat([crossed, crossed.new_zeros((pad, crossed.shape[1]))]
                       ).reshape(-1, 32, crossed.shape[1])
    union = int(groups.any(dim=1).sum())
    q = torch.quantile(live, torch.tensor([0.5, 0.9], device=live.device)
                       ).tolist() if live.numel() else [0.0, 0.0]
    return dict(live_rays=int(live.numel()),
                mean=float(live.mean()) if live.numel() else 0.0,
                p50=q[0], p90=q[1],
                max=int(live.max()) if live.numel() else 0,
                warp_union_x32=32 * union, sum_own=int(per_ray.sum()))


def _slot_stats(torch, ch, row_chunk, stream):
    """Live share of the slots, the mean real rows of the launched chunks
    (rows with prim id >= 0) and their last real row (as is, and rounded
    up to 8),
    and the 32-slot warps of live rows with no live slot."""
    k = ch.leaf_size
    pid = ch.rows.reshape(-1, k, ch.rows.shape[1])[:, :, 10]
    real = (pid >= 0.0).sum(dim=1)
    r_idx = torch.arange(1, k + 1, device=pid.device)
    last = torch.where(pid >= 0.0, r_idx, 0).amax(dim=1)
    last8 = (last + 7) // 8 * 8
    rc = row_chunk.long()
    live = (stream[:, 6] > 0.0).reshape(-1, 4, 32)
    row_live = live.reshape(-1, 128).any(dim=1)
    dead_warps = int((~live.any(dim=2) & row_live[:, None]).sum())
    return dict(rows=int(rc.numel()), slots=int(stream.shape[0]),
                live_share=float(live.float().mean()),
                mean_real_rows=float(real[rc].float().mean()),
                mean_last_real_row=float(last[rc].float().mean()),
                mean_walked_rows=float(last8[rc].float().mean()),
                leaf_size=k, dead_rows=int((~row_live).sum()),
                dead_warps_of_live_rows=dead_warps)


def _pairs_stats(torch, tpp, tl, runs, pt, packed, out, closest):
    """The pair walk's work on ray blocks, from a plain walk with the plain
    version's decisions (ROOT's helpers) that must give the kernel's
    output ``out`` (closest: (t, prim, b0, b1); occlusion: the bits):
    pairs and pairs visited (some lane's vote passes), yes votes and live
    lanes (t_max > 0) a visited pair, real rows and the rows to the last
    real one of the visited treelets, blocks by distinct shear frames of
    their live lanes (0-3), and the contract's forced lane-row tests;
    closest: the visited pairs after which some lane took a hit; occlusion:
    the lanes in S (crossing and unoccluded) a visited pair, the rows
    walked (r* + 1), lanes still testing at each row in the first port's
    schedule (every lane to r*) and in the redesign's (each lane to its
    first blocker, the non-crossing ones to r*)."""
    from yuki_tpu_torch.ops.trace_treelets import (_accept_in_order,
                                                   _edge_terms, _in_range,
                                                   _Rays, _slab)

    nb = runs.shape[0] - 1
    planes = tpp._block_planes(packed, nb)
    ox, oy, oz, dx, dy, dz, tm = planes[:7]
    rays = _Rays(ox, oy, oz, dx, dy, dz)
    k = tl.leaf_size
    rows = tl.rows.reshape(tl.n_treelets, k, -1)
    pid = rows[:, :, 10]
    real = (pid >= 0.0).sum(dim=1)
    last = torch.where(pid >= 0.0, torch.arange(1, k + 1, device=pid.device),
                       0).amax(dim=1)
    live = tm > 0.0
    acc = dict.fromkeys(("pairs", "visited", "votes", "live", "real_rows",
                         "last_rows", "forced", "took", "in_s", "walked",
                         "tests_first_port", "tests_redesign"), 0)
    testing = [torch.zeros(k, dtype=torch.int64, device=tm.device)
               for _ in range(2)]
    row_k = torch.arange(k, device=tm.device)
    t = tm.clone()
    prim = torch.full_like(tm, -1, dtype=torch.int32)
    b0, b1 = torch.zeros_like(tm), torch.zeros_like(tm)
    occ = torch.zeros_like(tm, dtype=torch.bool)
    skip = None if closest else planes[7]
    for on, tt in tpp._pair_steps(tl, runs, pt):
        box = tl.treelet_bounds[tt].T[:, :, None]
        if closest:
            vote = _slab(box, *(x[on] for x in rays.o),
                         *(x[on] for x in rays.inv), t[on])
        else:
            cross = _slab(box, *(x[on] for x in rays.o),
                          *(x[on] for x in rays.inv), tm[on])
            vote = cross & ~occ[on]
        visit = vote.any(dim=1)
        vb, tv = on[visit], tt[visit]
        acc["pairs"] += on.numel()
        acc["visited"] += vb.numel()
        if vb.numel() == 0:
            continue
        acc["votes"] += int(vote[visit].sum())
        acc["real_rows"] += int(real[tv].sum())
        acc["last_rows"] += int(last[tv].sum())
        tri = rows[tv]
        terms = _edge_terms(rays.lanes(vb, flat=False), tri)
        if closest:
            acc["live"] += int(live[vb].sum())
            acc["forced"] += int((live[vb].sum(dim=1) * real[tv]).sum())
            t0 = t[vb]
            t[vb], prim[vb], b0[vb], b1[vb] = _accept_in_order(
                tri, terms, t[vb], prim[vb], b0[vb], b1[vb])
            acc["took"] += int((t[vb] != t0).any(dim=1).sum())
            continue
        base_ok, det, t_scaled = terms[:3]
        blocked = (base_ok & _in_range(det, t_scaled, tm[vb][:, None, :])
                   & (tri[:, :, 9, None] != skip[vb][:, None, :])
                   & (tri[:, :, 10, None] >= 0.0))
        occ0 = occ[vb]
        c = cross[visit]
        after = occ0[:, None, :] | (torch.cummax(blocked.to(torch.int32),
                                                 dim=1).values > 0)
        still = (c[:, None, :] & ~after).any(dim=2)
        stop = torch.where(still, k - 1, row_k).amin(dim=1)
        occ[vb] = after.gather(1, stop[:, None, None].expand(
            -1, 1, tpp.BLOCK))[:, 0]
        open_ = live[vb] & ~occ0
        s_lanes = c & open_
        acc["live"] += int(open_.sum())
        acc["in_s"] += int(s_lanes.sum())
        acc["walked"] += int((stop + 1).sum())
        # Rows each lane tests: the first port, every lane to r*; the
        # redesign, each open lane to its first blocker (S: else to the
        # last real row; the others: else to r*, both within real rows).
        first = torch.where(blocked.any(dim=1),
                            blocked.to(torch.int32).argmax(dim=1),
                            k).to(torch.int64)
        lst = last[tv][:, None]
        cap = torch.where(s_lanes, lst, torch.minimum(stop[:, None] + 1, lst))
        n_rows = torch.where(open_, torch.minimum(first + 1, cap), 0)
        # The forced tests, counted as pairs_any_plain's "forced" is.
        first_real = torch.where(first < k, first + 1, real[tv][:, None])
        walked = torch.minimum(stop + 1, real[tv])[:, None]
        acc["forced"] += int(torch.where(c, first_real, torch.minimum(
            first_real, walked))[open_].sum())
        acc["tests_first_port"] += int(((stop + 1) * tpp.BLOCK).sum())
        acc["tests_redesign"] += int(n_rows.sum())
        testing[0] += (row_k[None, :] <= stop[:, None]).sum(dim=0) * tpp.BLOCK
        testing[1] += (row_k[None, None, :] < n_rows[:, :, None]).sum(
            dim=(0, 1))
    got = ((t, prim, b0, b1) if closest else (occ,))
    want = out if closest else (out,)
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x

    same = all(torch.equal(bits(g.reshape(-1)[:w.shape[0]]), bits(w))
               for g, w in zip(got, want))
    if not PROBING and not same:
        raise RuntimeError("pairs: the plain walk differs from the kernel")
    frame = shear_frames(torch, torch.stack([dx, dy, dz], -1).reshape(-1, 3))
    distinct = torch.stack([((frame.reshape(nb, -1) == f) & live).any(dim=1)
                            for f in range(3)]).sum(0)
    v = max(1, acc["visited"])
    res = dict(acc, blocks=nb, visited_share=acc["visited"] / max(
        1, acc["pairs"]), votes_per_visited=acc["votes"] / v,
        live_per_visited=acc["live"] / v,
        real_rows_mean=acc["real_rows"] / v,
        last_rows_mean=acc["last_rows"] / v,
        frames_per_block=torch.bincount(distinct, minlength=4).tolist())
    if closest:
        res["took_share"] = acc["took"] / v
    else:
        res.update(in_s_per_visited=acc["in_s"] / v,
                   walked_mean=acc["walked"] / v,
                   testing_first_port=testing[0].tolist(),
                   testing_redesign=testing[1].tolist())
    return res


def _pairs(torch, sm, res, tag, scene, bounce1, shadow, ms):
    """The pair walks on phase 13's waves (see the module's docstring)."""
    from yuki_tpu_torch.ops import trace_pairs as tpp

    tl = scene.data.treelets
    waves, caps = sm._pair_waves(torch, scene.data, (*bounce1, *shadow))
    for name, w in waves.items():
        closest = name == "pairs_closest"
        pb, pt, n_pairs, nb = tpp.block_candidate_pairs(tl, *w[:3],
                                                        caps[name])
        runs = tpp.pair_runs(pb, min(n_pairs, caps[name]), nb)
        packed = tpp._pack_rays(*w[:3], nb, None if closest else w[3])
        walk = tpp.pairs_closest_walk if closest else tpp.pairs_any_walk
        a, b, s_runs, s_pt, s_packed = sm._pair_slice(torch, tpp, w[2], runs,
                                                      pt, packed)
        s_n = (b - a) * tpp.BLOCK
        m = w[0].shape[0]
        counts = (runs[1:] - runs[:-1]).double()
        per_block = dict(mean=float(counts.mean()), max=int(counts.max()),
                         p99=float(torch.quantile(counts, 0.99)))
        kname = f"{name}_kernel"
        for what, args in (("slice", (s_runs, s_pt, s_packed, s_n)),
                           ("wave", (runs, pt, packed, m))):
            def fn():
                return walk(tl, *args)
            out = fn()
            key = f"{name} {what}"
            res["hashes"][key] = (digest(torch.cat([
                out[0].view(torch.int32), out[1], out[2].view(torch.int32),
                out[3].view(torch.int32)])) if closest else digest(out))
            res["ms"][key] = ms(fn, 10 if what == "slice" else 3)
            res["ms"][f"{key}: kernel device time"] = kernel_device_ms(
                torch, fn, kname, 10 if what == "slice" else 3)
            if what == "slice":
                st = _pairs_stats(torch, tpp, tl, s_runs, s_pt, s_packed, out,
                                  closest)
                res["notes"][key] = st
        res["notes"][f"{name} wave"] = dict(pairs=n_pairs, blocks=nb,
                                            pairs_per_block=per_block)
        sl, wv = f"{name} slice", f"{name} wave"
        extra = (f"visited pairs after which a lane took a hit {st['took']} "
                 f"({st['took_share']:.4f})" if closest else
                 f"lanes in S a visited pair {st['in_s_per_visited']:.1f}, "
                 f"rows walked (r* + 1) {st['walked_mean']:.2f}; lane-row "
                 f"tests, first port's schedule {st['tests_first_port']}, "
                 f"redesign's {st['tests_redesign']}; lanes testing rows 0, "
                 f"1, 2, 4, 8, 16, 32 (first port / redesign) "
                 + ", ".join(f"{st['testing_first_port'][r]}/"
                             f"{st['testing_redesign'][r]}"
                             for r in (0, 1, 2, 4, 8, 16, 32)
                             if r < tl.leaf_size))
        print(f"[{tag}] {name} [{m} sorted rays, {nb} blocks, {n_pairs} "
              f"pairs, a block's mean {per_block['mean']:.1f}, p99 "
              f"{per_block['p99']:.1f}, max {per_block['max']}]: whole wave "
              f"{res['ms'][wv]:.4f} ms a call, kernel device time "
              f"{res['ms'][wv + ': kernel device time']:.4f} ms; blocks "
              f"{a}-{b - 1} ({s_pt.numel()} pairs) {res['ms'][sl]:.4f} ms a "
              f"call, kernel device time "
              f"{res['ms'][sl + ': kernel device time']:.4f} ms [slice: "
              f"visited {st['visited']} ({st['visited_share']:.4f}), yes "
              f"votes a visited pair {st['votes_per_visited']:.1f}, live "
              f"lanes {st['live_per_visited']:.1f}, visited treelets' real "
              f"rows {st['real_rows_mean']:.2f}, to the last real "
              f"{st['last_rows_mean']:.2f} of {tl.leaf_size}; blocks by "
              f"distinct frames of live lanes (0-3) {st['frames_per_block']}; "
              f"forced lane-row tests {st['forced']}; {extra}]")
    return 0


def _treelet_out(torch, out):
    """A treelet walk's output as one tensor: t, prim, b0, b1 as int32
    bits (closest), or the occlusion bits."""
    if isinstance(out, torch.Tensor):
        return out
    return torch.cat([x.view(torch.int32) for x in out])


def _vote_counts(torch, tl, rays):
    """Each 1024-ray block's treelet votes at t_max within the supers it
    votes for at t_max: the estimate of a block's walk that a pre-pass
    could make before the walk, to launch the blocks longest first."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    planes, _ = ttt._pack(*rays[:3])
    walk, tm = ttt._Rays(*planes[:6]), planes[6]
    counts = torch.zeros(tm.shape[0], dtype=torch.int64, device=tm.device)
    for s, (t0, tc) in enumerate(tl.super_range.tolist()):
        in_super = walk.slab(tl.super_bounds[s], tm).any(dim=1)
        for tt in range(t0, t0 + tc):
            counts += in_super & walk.slab(tl.treelet_bounds[tt],
                                           tm).any(dim=1)
    return counts


def _permuted(torch, sm, res, tag, tl, name, walk, kname, rays, out, ms):
    """The wave launched most votes first by permuting its rays in whole
    1024-ray blocks (a block's output depends on its lanes alone), for a
    walk that launches its blocks in order: the outputs permuted back must
    equal ``out``; the count's own time (the checkout's treelet_votes, as
    device time, else the torch estimate _vote_counts, once) and the
    permuted wave's, a call (events) and as the walk's device time."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    block = 1024
    n = rays[0].shape[0]
    if n % block:
        return 0
    key = f"{name} wave, blocks permuted most votes first"
    if hasattr(ttt, "treelet_votes"):
        def count():
            return ttt.treelet_votes(tl, *rays[:3])
        res["ms"][key + ": vote count device time"] = kernel_device_ms(
            torch, count, "treelet_votes_kernel", 3)
        counts = count()
    else:
        counts, res["ms"][key + ": torch estimate"] = sm.timed_once(
            torch, lambda: _vote_counts(torch, tl, rays))
    order = torch.argsort(counts, descending=True, stable=True)
    perm = (order[:, None] * block + torch.arange(
        block, device=order.device)).reshape(-1)
    moved = [x[perm].contiguous() for x in rays]

    def fn():
        return walk(tl, *moved)
    got = fn()
    got = (got,) if isinstance(got, torch.Tensor) else got
    back = [torch.empty_like(g) for g in got]
    for b, g in zip(back, got):
        b[perm] = g
    same = torch.equal(_treelet_out(torch, back[0] if len(back) == 1
                                    else back), _treelet_out(torch, out))
    if not same and not PROBING:
        print(f"chip_ab: FAIL: {key} differs", file=sys.stderr)
        return 1
    res["ms"][key] = ms(fn, 3)
    res["ms"][key + ": kernel device time"] = kernel_device_ms(torch, fn,
                                                               kname, 3)
    c = counts.double()
    res["notes"][key] = dict(votes_mean=float(c.mean()),
                             votes_max=int(counts.max()),
                             votes_min=int(counts.min()))
    cost = {k.split(": ")[-1]: v for k, v in res["ms"].items()
            if k.startswith(key + ": ") and "kernel" not in k}
    print(f"[{tag}] {key} (votes at t_max: mean {float(c.mean()):.1f}, "
          f"min {int(counts.min())}, max {int(counts.max())}; the count's "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in cost.items())
          + f"): {res['ms'][key]:.4f} ms a call, kernel device time "
          f"{res['ms'][key + ': kernel device time']:.4f} ms")
    return 0


def _launch_order(torch, res, tag, tl, name, walk, kname, rays, out, ms):
    """A walk that orders its own blocks (most votes first), launched in
    block order instead, by setting trace_treelets._block_order to the
    identity for the calls (the vote count still runs, so a call's time
    holds it as the default's does): timed a call (events) and as the
    walk's device time; the outputs must equal ``out``."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    nb = -(-rays[0].shape[0] // ttt.BLOCK)
    identity = torch.arange(nb, dtype=torch.int32, device=rays[0].device)
    default = ttt._block_order

    def in_order(*args):
        default(*args)
        return identity
    key = f"{name} wave, launch order"
    ttt._block_order = in_order
    try:
        def fn():
            return walk(tl, *rays)
        same = torch.equal(_treelet_out(torch, fn()),
                           _treelet_out(torch, out))
        res["ms"][key] = ms(fn, 3)
        res["ms"][key + ": kernel device time"] = kernel_device_ms(
            torch, fn, kname, 3)
    finally:
        ttt._block_order = default
    if not same and not PROBING:
        print(f"chip_ab: FAIL: {key} differs", file=sys.stderr)
        return 1
    print(f"[{tag}] {key}: {res['ms'][key]:.4f} ms a call (with the vote "
          f"count), kernel device time "
          f"{res['ms'][key + ': kernel device time']:.4f} ms")
    return 0


def _treelets(torch, sm, res, tag, scene, camera, shadow0, bounce1, shadow1,
              ms):
    """The treelet walks on chip_smoke.py phase 6's four workloads (see
    the module's docstring)."""
    from yuki_tpu_torch.ops import trace_treelets as ttt

    sm.ops_ceiling(torch)
    tl = scene.data.treelets
    n = camera[0].shape[0]
    n_lights = shadow0[0].shape[0] // n
    sl = sm.SLICE_BLOCKS * ttt.BLOCK
    a, m = sm.bounce1_span(torch, bounce1[2])
    # A checkout whose closest walk launches its blocks most votes first
    # (treelet_votes) times it also in launch order; a walk that launches
    # its blocks in order is timed also with its rays permuted most votes
    # first (bounce-1 waves).
    ordered = hasattr(ttt, "treelet_votes")
    cases = (("treelet_closest camera", camera, [(0, sl)]),
             ("treelet_any bounce-0 shadow", shadow0,
              [(li * n, li * n + sl) for li in range(n_lights)]),
             ("treelet_closest bounce-1", bounce1, [(a, a + m)]),
             ("treelet_any bounce-1 shadow", shadow1,
              [(li * n + a, li * n + a + m) for li in range(n_lights)]))
    for name, rays, spans in cases:
        closest = len(rays) == 3
        walk = ttt.treelet_closest if closest else ttt.treelet_any
        kname = "treelet_closest_kernel" if closest else "treelet_any_kernel"

        def wave():
            return walk(tl, *rays)

        def slices():
            return [walk(tl, *(x[lo:hi] for x in rays)) for lo, hi in spans]
        out = wave()
        res["hashes"][f"{name} wave"] = digest(_treelet_out(torch, out))
        res["hashes"][f"{name} slice"] = digest(torch.cat([
            _treelet_out(torch, x) for x in slices()]))
        for what, fn, reps in (("wave", wave, 3), ("slice", slices, 10)):
            key = f"{name} {what}"
            res["ms"][key] = ms(fn, reps)
            res["ms"][f"{key}: kernel device time"] = kernel_device_ms(
                torch, fn, kname, reps)
            if ordered and closest:
                res["ms"][f"{key}: vote count device time"] = \
                    kernel_device_ms(torch, fn, "treelet_votes_kernel", reps)
        work = sm.treelet_work(torch, tl, rays, spans,
                               None if PROBING else out)
        floor_ms, at_sms = sm.treelet_floor(torch, work)
        per = torch.tensor(work.pop("per_block"), dtype=torch.float64)
        v = max(1, work["visited"])
        note = dict(work, floor_ms=floor_ms, floor_at_sms_ms=at_sms,
                    visits_per_block_mean=float(per.mean()),
                    visits_per_block_max=int(per.max()),
                    live_per_visit=work["live"] / v,
                    real_rows_per_visit=work["real_rows"] / v,
                    took_share=work["took"] / v)
        res["notes"][f"{name} slice"] = note
        wv, sv = f"{name} wave", f"{name} slice"
        votes = (f", vote count device time "
                 f"{res['ms'][wv + ': vote count device time']:.4f} ms"
                 if ordered and closest else "")
        print(f"[{tag}] {name} [{rays[0].shape[0]} rays, "
              f"{int((rays[2] > 0).sum())} with t_max > 0]: whole wave "
              f"{res['ms'][wv]:.4f} ms a call, kernel device time "
              f"{res['ms'][wv + ': kernel device time']:.4f} ms{votes}; slice "
              f"(rays {spans[0][0]}-{spans[0][1] - 1} of each of "
              f"{len(spans)} light(s)) {res['ms'][sv]:.4f} ms a call, kernel "
              f"device time {res['ms'][sv + ': kernel device time']:.4f} ms "
              f"[slice: {work['blocks']} blocks, super visits "
              f"{work['supers']}, treelet visits {work['visited']} (a block's"
              f" mean {note['visits_per_block_mean']:.1f}, max "
              f"{note['visits_per_block_max']}), live lanes a visit "
              f"{note['live_per_visit']:.1f}, real rows a visit "
              f"{note['real_rows_per_visit']:.2f} of {tl.leaf_size}, visits "
              f"after which a lane took a hit {work['took']}; contract's "
              f"floor {floor_ms:.4f} ms ({work['forced']} forced tests), "
              f"{at_sms:.4f} ms at the SMs the blocks fill]")
        if "bounce-1" in name:
            rc = (_launch_order(torch, res, tag, tl, name, walk, kname, rays,
                                out, ms) if ordered and closest else
                  _permuted(torch, sm, res, tag, tl, name, walk, kname, rays,
                            out, ms))
            if rc:
                return rc
    return 0


def kernel_device_ms(torch, fn, name, reps=10):
    """Device time per call of the kernels whose name holds ``name`` in fn
    (torch.profiler, after one warm-up call): the kernel alone, without
    the wrapper's host time between launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    _, parts = device_times(torch, prof, (name,))
    return parts[name][0] / reps


def _stream(torch, sm, res, tag, scene, bounce1, shadow, ms):
    """The crossing words and the slot walks on the colonnade's bounce-1
    and shadow rays (see the module's docstring)."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_cull as tcu
    from yuki_tpu_torch.ops import trace_stream as ts

    ch, meta = scene.data.chunks, scene.meta
    o2, d2, t2 = bounce1
    no2, nd2, nt2, sk2 = shadow
    n = o2.shape[0]
    lists, ov = tcu.candidate_lists_fused(ch, o2, d2, t2, ts.C_MAIN)
    idx = torch.nonzero(ov).squeeze(1)
    n_ov = int(idx.numel())
    waves = {
        "1 overflow ray": idx[:1],
        "32 overflow rays": idx[:32],
        f"{n_ov} overflow rays": idx,
        f"{SLICE_RAYS}-ray slice": torch.arange(SLICE_RAYS, device=o2.device),
        f"{n}-ray wave": torch.arange(n, device=o2.device),
    }
    for what, sel in waves.items():
        o, d, t = (x[sel].contiguous() for x in (o2, d2, t2))
        words = ts.cross_words(ch, o, d, t)
        res["hashes"][f"cross_words {what}"] = digest(words)
        t_k = ms(lambda: ts.cross_words(ch, o, d, t),
                 10 if o.shape[0] > 65536 else 20)
        t_dev = kernel_device_ms(torch, lambda: ts.cross_words(ch, o, d, t),
                                 "cross_words_kernel")
        res["ms"][f"cross_words {what}"] = t_k
        res["ms"][f"cross_words {what}: kernel device time"] = t_dev
        note = ""
        if o.shape[0] >= 2048:
            st = _crossed_word_stats(torch, ts, ch, o, d, t)
            st["chunk_bits"] = int(ts.popcount32(words).sum())
            res["notes"][f"cross_words {what}"] = st
            note = (f"; crossed word boxes per live ray mean "
                    f"{st['mean']:.2f}, median {st['p50']:.0f}, p90 "
                    f"{st['p90']:.0f}, max {st['max']}; a warp's union x 32 "
                    f"{st['warp_union_x32']} against the rays' own "
                    f"{st['sum_own']} ({st['warp_union_x32'] / max(1, st['sum_own']):.2f}x)"
                    f"; {st['chunk_bits']} chunk crossings")
        print(f"[{tag}] cross_words [{what}]: {t_k:.4f} ms a call, kernel "
              f"device time {t_dev:.4f} ms{note}")

    k = ch.leaf_size
    # The wide re-run of the overflow rays, as traverse._closest_dispatch
    # makes it.
    o, d, t = (x[idx].contiguous() for x in (o2, d2, t2))
    w_lists, _ = ts.extract_lists(ts.cross_words(ch, o, d, t), ts.C_WIDE)
    wide = (ts._slots(ch, w_lists, ts.C_WIDE,
                      (ts.WIDE_LOW_MULT, ts.WIDE_TIGHT_MULT), ts.C_WIDE,
                      traverse._wide_cap(n_ov)), (o, d, t, None))
    main = (ts._slots(ch, lists, ts.C_MAIN, meta.slot_mult_tight,
                      meta.slot_mult, n), (o2, d2, t2, None))
    co, cd, ct, cs = sm._combine(torch, o2, d2, t2, no2, nd2, nt2, sk2)
    c_lists, _ = tcu.candidate_lists_fused(ch, co, cd, ct, ts.C_MAIN)
    comb = (ts._slots(ch, c_lists, ts.C_MAIN, meta.slot_mult_tight,
                      meta.slot_mult, co.shape[0]), (co, cd, ct, cs))
    s_lists, _ = tcu.candidate_lists_fused(ch, no2, nd2, nt2, ts.C_MAIN)
    shadow_slots = (ts._slots(ch, s_lists, ts.C_MAIN,
                              max(3, meta.slot_mult_tight - 1),
                              max(4, meta.slot_mult - 2), no2.shape[0]),
                    (no2, nd2, nt2, sk2))
    cases = (("slot_closest", "bounce-1 slots", main, False),
             ("slot_closest", "wide re-run slots", wide, False),
             ("slot_closest_skip", "combined wave slots", comb, True),
             ("slot_closest", "combined wave slots", comb, False),
             ("slot_any", "shadow slots", shadow_slots, None))
    for name, what, (slots, (o, d, t, extra)), skip in cases:
        if slots is None:
            print(f"chip_ab: FAIL: {name} on {what}: the slot budget blew",
                  file=sys.stderr)
            return 1
        _, slot_ray, row_chunk, valid = slots
        stream = ts._pack_stream(o, d, t, slot_ray, valid, extra=extra)
        if skip is None:
            def fn():
                return ts.slot_any(ch.rows, k, row_chunk, stream)
        else:
            def fn():
                return ts.slot_closest(ch.rows, k, row_chunk, stream, skip)
        res["hashes"][f"{name} {what}"] = digest(fn())
        t_k = ms(fn)
        t_dev = kernel_device_ms(torch, fn, name.replace("_skip", "")
                                 + "_kernel")
        res["ms"][f"{name} {what}"] = t_k
        res["ms"][f"{name} {what}: kernel device time"] = t_dev
        st = _slot_stats(torch, ch, row_chunk, stream)
        note = ""
        if skip is None and not PROBING:
            st.update(_any_stats(torch, ch, row_chunk, stream, fn()))
            note = (f"; {st['live_slots']} live slots, "
                    f"{st['occluded_share']:.4f} of them occluded after "
                    f"{st['rows_to_first_occluder']:.2f} rows on average; "
                    f"the unoccluded slots' chunks hold "
                    f"{st['unoccluded_real_rows']:.2f} real rows, the last "
                    f"at {st['unoccluded_rows_to_last_real']:.2f}")
        res["notes"][f"{name} {what}"] = st
        print(f"[{tag}] {name} [{what}: {st['rows']} rows, live share "
              f"{st['live_share']:.4f}, {st['dead_rows']} dead rows, "
              f"{st['dead_warps_of_live_rows']} dead warps of live rows, "
              f"real rows of the launched chunks {st['mean_real_rows']:.2f}"
              f" (to the last real {st['mean_last_real_row']:.2f}, rounded "
              f"to 8 {st['mean_walked_rows']:.2f}) of {k}]: {t_k:.4f} ms a "
              f"call, kernel device time {t_dev:.4f} ms{note}")
    return 0


def probe(root, tag, out_path, parts="bounce,stream", kernels=None):
    """``run`` on a copy of ROOT's package whose walks PROBE_EDITS cut
    (``kernels``: a comma-separated subset of its keys, default all; the
    others keep their walks, so waves made by them are the real ones)."""
    global PROBING
    dst = os.path.join(HERE, "build", f"probe-{tag}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "yuki_tpu_torch"),
                    os.path.join(dst, "yuki_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "yuki_tpu_torch", "ops", "csrc")
    chosen = set(PROBE_EDITS if kernels is None else kernels.split(","))
    for kernel, alternatives in PROBE_EDITS.items():
        if kernel not in chosen:
            continue
        done = 0
        for name, old, new in alternatives:
            path = os.path.join(csrc, name)
            with open(path) as f:
                src = f.read()
            if src.count(old) == 1:
                with open(path, "w") as f:
                    f.write(src.replace(old, new))
                done += 1
            elif old not in src and src.count(new) == 1:
                done += 1  # a shared header another kernel's edit cut
        if done != 1:
            print(f"chip_ab: FAIL: probe: {done} edits of {kernel} apply",
                  file=sys.stderr)
            return 1
    PROBING = True
    return run(dst, tag, out_path, parts)


def _write(res, out_path):
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    return 0


def compare(a_path, b_path):
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    print(f"A = {a['tag']} ({a['card']}), B = {b['tag']} ({b['card']})")
    for k in sorted(set(a["ptxas"]) | set(b["ptxas"])):
        print(f"ptxas {k}: A {' | '.join(a['ptxas'].get(k, []))}; "
              f"B {' | '.join(b['ptxas'].get(k, []))}")
    for k, ta in a["ms"].items():
        if k not in b["ms"]:
            continue
        tb = b["ms"][k]
        ratio = f"{tb / ta:.3f}x" if tb and ta else "-"
        print(f"{k}: A {ta:.4f} ms, B {tb:.4f} ms, B/A {ratio}")
    both = [k for k in a["hashes"] if k in b["hashes"]]
    bad = [k for k in both if b["hashes"][k] != a["hashes"][k]]
    print(f"{len(both) - len(bad)} of {len(both)} outputs measured by both "
          f"equal bit for bit" + (f"; differ: {bad}" if bad else ""))
    return 1 if bad else 0


if __name__ == "__main__":
    if len(sys.argv) in (5, 6) and sys.argv[1] in ("run", "probe"):
        sys.exit((run if sys.argv[1] == "run" else probe)(*sys.argv[2:]))
    if len(sys.argv) == 7 and sys.argv[1] == "probe":
        sys.exit(probe(*sys.argv[2:]))
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(*sys.argv[2:]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
