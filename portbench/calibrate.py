"""Readings that the check's limits are set from, for one cell, in one
process on the card:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--control]

For each seed the program renders as many frames as a run checks, at the
cell's own sizes and load, and the check compares them with the float32
reference (the lower readings).  With ``--control`` the reference in
bfloat16 is put in the program's place on the same pixels, samples and
seeds, and compared the same way (the upper readings).  One JSON line a
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import harness as H


def control_records(cell, records, px, py, device, ref_low):
    """The records with every kept sample and film value replaced by the
    reference's in its lower precision."""
    from .reference.integrate import pixel_mean, render_samples
    from .reference.rmath import camera_matrices

    sc, cam = ref_low
    c2w, r2c = camera_matrices(cam, *cell.cfg["res"])
    sampler, integ = H.reference_objects(cell.traffic, sc.dtype)
    pxd = torch.as_tensor(px, device=device)
    pyd = torch.as_tensor(py, device=device)
    n_pix = pxd.shape[0]
    out = []
    for record in records:
        calls, by_s = [], {}
        for ok, li, rc, s, seed in record["calls"]:
            ok = ok.to(device)
            li2 = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
            rc2 = torch.zeros(n_pix, dtype=torch.int64, device=device)
            idx = torch.nonzero(ok)[:, 0]
            if idx.numel():
                v, r = render_samples(sc, c2w, r2c, sampler, integ, pxd[idx],
                                      pyd[idx], s, seed)
                li2[idx] = v.to(torch.float32)
                rc2[idx] = r
                full = by_s.setdefault(s, torch.zeros((n_pix, 3), dtype=sc.dtype,
                                                      device=device))
                full[idx] = v
            calls.append((ok, li2, rc2, s, seed))
        film = pixel_mean([by_s[s] for s in sorted(by_s)], sampler.spp)
        out.append(dict(index=record["index"], film=film.to(torch.float32),
                        calls=calls))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    cell = H.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: FAIL: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    work_dir = os.path.join(H.WORK_DIR, cell.config_name)
    os.makedirs(work_dir, exist_ok=True)
    scene, cam, fs = cell.module.program_scene(cell.cfg, device, work_dir)
    sampler, integ = H.program_objects(cell.traffic)
    ref = cell.module.reference_scene(cell.cfg, device, torch.float32, work_dir)
    ref_low = (cell.module.reference_scene(cell.cfg, device, torch.bfloat16,
                                           work_dir) if args.control else None)
    td = int(cell.cfg["tile_dim"])
    w, h = cell.cfg["res"]
    k = int(cell.traffic["check_frames"])
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        px, py = H.sample_pixels(seed, (w, h), td,
                                 int(cell.traffic["check_pixels"]))
        rec = H.Recorder(device, -(-w // td) * td, -(-h // td) * td, px, py)
        rec.install()
        try:
            _, records = H.run_window(cell, scene, cam, fs, sampler, integ, rec,
                                      seed, 0.0, False, px, py, device,
                                      lambda s: None, min_frames=k)
        finally:
            rec.restore()
        line = {"seed": seed}
        for name, recs in (("program", records),) + (
                (("control", control_records(cell, records, px, py, device,
                                             ref_low)),) if ref_low else ()):
            c = H.check_frames_against(cell, recs, px, py, device,
                                       torch.float32, ref)
            line[name] = {"mismatch_share": c.share(), "samples": c.samples,
                          "bad_samples": c.bad_samples,
                          "clean_pixels": c.clean_pixels,
                          "bad_pixels": c.bad_pixels}
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
