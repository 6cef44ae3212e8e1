#!/usr/bin/env python3
"""A/B of the redesigned kernels (the two-level cull, the dense bounce,
the crossing words, the slot walks, raygen, the row-union closest walk
and the dense closest sweep) between two checkouts of this repository, on
one NVIDIA GPU.

    python3 chip_ab.py run ROOT TAG OUT.json [PARTS]   # measure ROOT's port
    python3 chip_ab.py probe ROOT TAG OUT.json [PARTS] # the same, walks cut
    python3 chip_ab.py compare A.json B.json           # A against B

PARTS is a comma-separated subset of bounce,cull,stream,frames,rows,dense
(default: all), or raygen (bounce's raygen measurements alone).

``probe`` copies ROOT's ``yuki_tpu_torch`` to ``build/probe-TAG/``, cuts
the walks of the occlusion slot walk, the row-union closest walk, the
dense closest sweep and the raygen kernel's sweep to zero triangles (and
raygen's to zero spheres) by a text edit of the copy's sources
(``PROBE_EDITS``), and runs ``run`` on the copy: its times are those of
the kernels' stage, rechecks, barriers, loads and stores alone.  Its
digests differ from ROOT's by design.

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
- the one-kernel wave on the same Cornell wave;
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
  wave (camera + bounce-0 shadow lanes, 1,572,864); ``dense``: the dense
  closest sweep on Cornell's 1080p camera wave (1,048,576 rays), on the
  path_li frame's bounce-1 rays, on a 4096-triangle soup (65,536 rays,
  ``chip_smoke.py``'s) and, with and without skip, on phase 12a's
  combined wave (2,097,152 lanes); each timed a call and as the kernel's
  device time, with the statistics of its work from a plain torch walk
  that must give the kernel's output (``_rows_stats``, ``_dense_stats``);
- the 1080p d5 16 spp Cornell frame, the 1080p d5 1 spp Cornell frame
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
                "rows_closest_kernel", "dense_closest_kernel")
DENSE_KERNELS = ("dense_closest_kernel", "dense_any_kernel")
COL_KERNELS = ("cull_kernel", "cross_words_kernel", "slot_closest_kernel",
               "slot_any_kernel", "rows_closest_kernel",
               "walker_closest_kernel", "walker_any_kernel")
# The probe's edits: for each kernel, alternatives (source, old, new), of
# which exactly one must occur once in the checkout's source (the code
# before the kernel's redesign, or after it); each cuts the kernel's walk
# to zero triangles and leaves its stage, loads and stores.
PROBE_EDITS = {
    "slot_any_kernel": (
        ("trace_stream.cu", "for (int r = 0; r < k; ++r) {",
         "for (int r = 0; r < 0; ++r) {"),
        ("trace_stream.cu", "for (int r = 0; r < last; ++r) {",
         "for (int r = 0; r < 0; ++r) {"),
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
    a profile."""
    busy, parts = 0.0, {k: [0.0, 0] for k in names}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        t = float(getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3
        busy += t
        for k in names:
            if k in e.key:
                parts[k][0] += t
                parts[k][1] += int(e.count)
    return busy, {k: tuple(v) for k, v in parts.items()}


def run(root, tag, out_path, parts="bounce,cull,stream,frames,rows,dense"):
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
        wave_out = tpf.wave(px, py, si, 1, tb, spl)
        res["hashes"][f"wave {sam_name}"] = digest(wave_out)
        res["ms"][f"wave {sam_name}"] = ms(
            lambda: tpf.wave(px, py, si, 1, tb, spl), 10)
        print(f"[{tag}] wave {sam_name}: {res['ms'][f'wave {sam_name}']:.4f}"
              " ms")

    # ---- the dense closest sweep on Cornell's waves and a soup ----------
    if "dense" in parts:
        _dense(torch, sm, res, tag, ms)

    # ---- the cull on the colonnade's bounce-1 and shadow rays -------------
    if not parts & {"cull", "stream", "frames", "rows"}:
        return _write(res, out_path)
    scene, cam, _ = colonnade(device=dev)
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

    # ---- the row-union closest walk ------------------------------------
    if "rows" in parts:
        _rows(torch, sm, res, tag, scene, (o, d, t_max, *out0[5:9]), ms)

    # ---- frames ---------------------------------------------------------
    fs = FilmSettings(res=(1920, 1080), tile_dim=16)
    cscene, ccam, _ = cornell(device=dev)

    def cornell_path_li():
        tpf.PATH_FUSED_MODE = "off"
        try:
            return render_frame(cscene, ccam, fs, UniformSampler(1),
                                PathParams(DEPTH), wave_tiles=CORNELL_TILES,
                                seed=1)
        finally:
            tpf.PATH_FUSED_MODE = "auto"

    def colonnade_frame(walker):
        def frame():
            sm._walker_flags(walker)
            try:
                return render_frame(scene, cam, fs, UniformSampler(1),
                                    PathParams(DEPTH), wave_tiles=COL_TILES,
                                    seed=1)
            finally:
                sm._walker_flags(False)
        return frame

    frames = {
        "cornell 1080p d5 16 spp": (lambda: render_frame(
            cscene, ccam, fs, UniformSampler(SPP), PathParams(DEPTH),
            wave_tiles=CORNELL_TILES, samples_per_launch=SPP, seed=1),
            ("bounce_kernel",)),
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


def _dense(torch, sm, res, tag, ms):
    """The dense closest sweep (see the module's docstring)."""
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
    soup, _, so, sd, st_, _ = sm._soup(torch, dev)
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


def _rows(torch, sm, res, tag, scene, wave0, ms):
    """The row-union closest walk (see the module's docstring)."""
    from yuki_tpu_torch import traverse
    from yuki_tpu_torch.ops import trace_rows as trw

    ch = scene.data.chunks
    o, d, t_max = wave0[:3]
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


def probe(root, tag, out_path, parts="bounce,stream"):
    """``run`` on a copy of ROOT's package whose walks PROBE_EDITS cut."""
    global PROBING
    dst = os.path.join(HERE, "build", f"probe-{tag}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "yuki_tpu_torch"),
                    os.path.join(dst, "yuki_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dst, "yuki_tpu_torch", "ops", "csrc")
    for kernel, alternatives in PROBE_EDITS.items():
        done = 0
        for name, old, new in alternatives:
            path = os.path.join(csrc, name)
            with open(path) as f:
                src = f.read()
            if src.count(old) == 1:
                with open(path, "w") as f:
                    f.write(src.replace(old, new))
                done += 1
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
    if len(sys.argv) == 4 and sys.argv[1] == "compare":
        sys.exit(compare(*sys.argv[2:]))
    print(__doc__, file=sys.stderr)
    sys.exit(2)
