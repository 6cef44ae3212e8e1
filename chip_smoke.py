#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the kernels are built from
yuki_tpu_torch/ops/csrc at first use, into build/yuki_tpu_torch/) and the
yuki_tpu_torch package beside this file.  It imports no JAX.  Phases:

  1. the card (nvidia-smi name and power limit), CUDA version, kernel
     build time and the bounce kernel's ptxas register/spill report;
  2. each kernel against its plain PyTorch version on one 4096-tile wave
     of the 1080p Cornell film (1,048,576 rays, depth 5): raygen_trace,
     one bounce at bounce 0 and at bounce 3 from the same state, and the
     whole wave; with each kernel's time beside the plain version's;
  3. the golden: Cornell 64x48, depth 4, 8 spp, seed 42 through
     make_wave_renderer on the card against
     tests/goldens/cornell_64x48_path4_8spp_seed42.npz (rendered by the
     JAX reference) under the chaos-aware bounds;
  4. the main path: render_frame on Cornell at 1920x1080, depth 5,
     UniformSampler 16 spp, 16-pixel tiles, 4096-tile waves, seed 1,
     counting kernel launches; the image must be finite, non-black and
     have the red wall left and the green wall right.

Prints one JSON line describing the kernels, then as its last line
{"ok": true, "device": {...}}.  Any failed phase prints the reason to
stderr and exits with status 1 without those lines.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WAVE_TILES = 4096
RES = (1920, 1080)
DEPTH = 5
SPP = 16
GOLDEN = os.path.join(REPO, "tests", "goldens",
                      "cornell_64x48_path4_8spp_seed42.npz")
KERNEL_SOURCE = "yuki_tpu_torch/ops/csrc/path_fused.cu"
REPLACES = {
    "raygen_trace": "yuki_tpu/ops/path_fused.py:517",
    "bounce": "yuki_tpu/ops/path_fused.py:709",
}
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


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    from yuki_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.library()
    print(f"kernel build+load: {time.monotonic() - t0:.2f} s "
          f"({_build.BUILD_DIR})")
    for line in _build.ptxas_report.splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line) \
                or "spill" in line:
            print(f"ptxas: {line.strip()}")
    return card


def phase_kernels(torch, np, dev):
    """Kernel vs plain version at main-path shapes."""
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
    n = px.shape[0]
    check(n == WAVE_TILES * td * td, f"wave has {n} rays")
    si, seed = 0, 1
    st = tpf._ST
    result = {}

    # raygen_trace
    st_k, ph_k = tpf.raygen_trace(px, py, si, seed, tb)
    st_p, ph_p = tpf.raygen_trace_plain(px, py, si, seed, tb)
    torch.cuda.synchronize()
    check(torch.equal(ph_k, ph_p), "raygen: sampler hash differs")
    for k in ("prim", "sph", "hitf"):
        check(torch.equal(st_k[st[k]], st_p[st[k]]), f"raygen: {k} differs")
    err = 0.0
    for k in ("ox", "oy", "oz", "dx", "dy", "dz", "t", "b0", "b1"):
        a, b = st_k[st[k]], st_p[st[k]]
        check(torch.allclose(a, b, rtol=1e-6, atol=1e-7),
              f"raygen: {k} outside rtol 1e-6 / atol 1e-7")
        err = max(err, float((a - b).abs().max()))
    ms_k = cuda_ms(torch, lambda: tpf.raygen_trace(px, py, si, seed, tb), 10)
    ms_p = cuda_ms(torch, lambda: tpf.raygen_trace_plain(px, py, si, seed,
                                                         tb), 3)
    print(f"raygen_trace [{n} rays]: kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.4f} ms, max_abs_err {err:.3g}")
    result["raygen_trace"] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)

    # bounce at 0 and 3, each kernel vs plain from one input state
    states = {0: st_k}
    s_in = st_k
    for b in range(3):
        s_in = tpf.bounce(s_in, ph_k, b, tb)
    states[3] = s_in
    err = 0.0
    times = {}
    for b, s_in in states.items():
        out_k = tpf.bounce(s_in, ph_k, b, tb)
        out_p = tpf.bounce_plain(s_in, ph_k, b, tb)
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
        print(f"bounce {b} [{n} rays, {alive} alive]: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms, next-hit ids agree {same:.6f}")
        times[b] = (t_k, t_p)
    result["bounce"] = dict(max_abs_err=err, ms=times[0][0],
                            plain_ms=times[0][1])

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


def phase_golden(torch, np, dev):
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
    print(f"golden cornell 64x48 d4 8spp seed 42: divergent px {n_bad} "
          f"(limit {limit}), mean rel diff {mean_rel:.3g}, rmse {rmse:.4g}")


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
    tpf.reset_launches()
    res = render_frame(scene, cam, fs, UniformSampler(SPP),
                       PathParams(max_depth=DEPTH), wave_tiles=WAVE_TILES,
                       samples_per_launch=SPP, seed=1)
    torch.cuda.synchronize()
    launches = dict(tpf.LAUNCHES)
    for name, count in launches.items():
        check(count > 0, f"main path: kernel {name} never launched")
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
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    print(f"chip_smoke: all phases passed in {time.monotonic() - t0:.1f} s")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=KERNEL_SOURCE,
             replaces=REPLACES[name], launches=launches[name], **kernels[name])
        for name in ("raygen_trace", "bounce")
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
