#!/usr/bin/env python3
"""Where the time of the semantic sweep goes on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/profile_torch_sweep.py [--root DIR]

``--root`` imports ``convexadam_torch`` from another checkout (for example an
unpacked parent commit), so two versions can be profiled in one run of the
card; the inputs always come from this checkout's ``chip_smoke.py``.

On ``chip_smoke.py``'s phase-5 subjects (three 13-organ label volumes at the
Learn2Reg Abdomen shape 192 x 160 x 256) and its first pair, it runs
``run_stage1_sweep`` with the first seeded setting of each of phase 5a's
classes, and ``run_stage2_sweep`` with each of phase 5b's Adam settings, one
run a setting after a warm-up, each under ``torch.profiler``, and reports
per run

* the setting's seconds (``times[0]``, one pair) and the profiled wall time;
* the host time of the engine's ``record_function`` ranges (``sweep.*``:
  the convex field, Adam, the stage-2 variants' upsampling and smoothing,
  the per-field evaluation, the HD95 scoring, the fetch of each pair's
  scalars, which is where the host waits for the card) with the device
  time of the kernels launched inside each;
* the device time by kernel name and the device-busy share (summed device
  time over the profiled wall time).

It prints a JSON line per run and writes
``chiprun_out/profile_torch_sweep.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    # the inputs come from this checkout, the package from --root
    from chip_smoke import L2R_LABELS, SWEEP_ADAM_GRIDS, SWEEP_CLASSES, SWEEP_PAIRS, sweep_subjects

    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import convexadam_torch
    from convexadam_torch.kernels import _build
    from convexadam_torch.selfconfig import (
        run_stage1_sweep,
        run_stage2_sweep,
        stage1_settings,
        stage2_settings,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    segs = sweep_subjects()
    pairs = SWEEP_PAIRS[:1]
    s1 = stage1_settings()
    stage1 = [next(s for s in s1 if (s.grid_sp, s.disp_hw) == c) for c in SWEEP_CLASSES]
    adam = [next(s for s in stage2_settings() if s.grid_sp_adam == g) for g in SWEEP_ADAM_GRIDS]
    runs = [("stage1", st, lambda st=st: run_stage1_sweep(segs, segs, pairs, [st], L2R_LABELS))
            for st in stage1]
    runs += [("stage2", st, lambda st=st: run_stage2_sweep(segs, segs, pairs, stage1[0], [st],
                                                           L2R_LABELS))
             for st in adam]
    out = []
    for stage, st, run in runs:
        run()  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ranges, kernels, device_us = {}, [], 0.0
        for e in prof.key_averages():
            if e.key.startswith("sweep."):
                if e.device_type == torch.autograd.DeviceType.CPU:
                    ranges[e.key] = {"host_ms": e.cpu_time_total / 1e3, "count": e.count,
                                     "device_ms": e.device_time_total / 1e3}
                continue
            if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
                continue
            kernels.append({"name": e.key[:90], "count": e.count,
                            "device_ms": e.self_device_time_total / 1e3})
            device_us += e.self_device_time_total
        kernels.sort(key=lambda r: -r["device_ms"])
        row = {"stage": stage, "setting": str(st), "card": smi,
               "package": str(pathlib.Path(convexadam_torch.__file__).parent),
               "setting_s": float(res.times[0]), "profiled_wall_s": wall, "ranges": ranges,
               "device_busy_ms": device_us / 1e3, "device_busy_share": device_us / 1e6 / wall,
               "top_device_ops": kernels[:15]}
        out.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "top_device_ops"}), flush=True)
        for r in kernels[:8]:
            print(f"{r['device_ms']:10.3f} ms  x{r['count']:<7d} {r['name']}", flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_torch_sweep.json").write_text(json.dumps(out, indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
