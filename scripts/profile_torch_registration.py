#!/usr/bin/env python3
"""Where the time of one default MIND registration goes on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/profile_torch_registration.py [--runs 3]

On the 192^3 headline pair of ``chip_smoke.py`` (seed 0, shift (5, -4, 3),
default config, bfloat16 features) it reports

* the host-clock time of each stage (median of ``--runs``, each stage ending
  in ``torch.cuda.synchronize()``): MIND features, convex stage (pooling,
  cost volumes, coupled convex, inverse consistency, resize), Adam stage
  (80 iterations) and the copy of the field to the host;
* the two entry points, ``convex_adam`` (numpy in and out) and
  ``convex_adam_torch`` (tensors on the card), timed the same way;
* one registration under ``torch.profiler``: device time by kernel name
  (the port's own kernels listed apart, per launch), and the device-busy
  share (summed device time over the profiled wall time).

It prints a JSON line and writes ``chiprun_out/profile_torch_registration.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import HEADLINE_SHAPE, headline_pair
    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import _build
    from convexadam_torch.pipeline.convex_adam import (
        ConvexAdamConfig,
        _adam_stage,
        _convex_stage,
        convex_adam,
        convex_adam_torch,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    cfg = ConvexAdamConfig()
    dt = cfg.compute_dtype(dev)
    vol_np, mov_np = headline_pair(torch, resize_trilinear)
    f = torch.from_numpy(vol_np).to(dev)
    m = torch.from_numpy(mov_np).to(dev)

    def stages():
        out = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            ff = mindssc(f, cfg.mind_r, cfg.mind_d, dtype=dt)
            fm = mindssc(m, cfg.mind_r, cfg.mind_d, dtype=dt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            init = _convex_stage(ff, fm, cfg, HEADLINE_SHAPE, for_adam_init=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        field, _ = _adam_stage(ff, fm, init, cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        field.detach().permute(1, 2, 3, 0).cpu().numpy()
        t4 = time.perf_counter()
        out["features_s"] = t1 - t0
        out["convex_stage_s"] = t2 - t1
        out["adam_stage_s"] = t3 - t2
        out["to_host_s"] = t4 - t3
        out["total_s"] = t4 - t0
        return out

    def entry(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    stages()  # warm-up
    runs = [stages() for _ in range(args.runs)]
    median = {k: float(np.median([r[k] for r in runs])) for k in runs[0]}
    # the two entry points: numpy in and out, and tensors on the card
    median["convex_adam_numpy_s"] = float(np.median([
        entry(lambda: convex_adam(vol_np, mov_np, device="cuda")) for _ in range(args.runs)
    ]))
    median["convex_adam_torch_s"] = float(np.median([
        entry(lambda: convex_adam_torch(f, m, cfg)) for _ in range(args.runs)
    ]))

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        convex_adam_torch(f, m, cfg).cpu()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device events only (kernels, memcpy, memset): CPU ops also carry the
    # device time of the kernels they launch, and so do user annotations on
    # the device timeline (the optimiser's step range): either would count
    # it twice
    rows = []
    device_us = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        dev_us = e.self_device_time_total
        rows.append({"name": e.key[:90], "count": e.count, "device_ms": dev_us / 1e3})
        device_us += dev_us
    rows.sort(key=lambda r: -r["device_ms"])
    own = ("mind_kernel", "cost_volume_kernel", "sample_trilinear_kernel", "ic_step_kernel",
           "sample_trilinear_bwd_kernel", "warp_ssd_kernel", "sum_partials_kernel")
    kernels = {
        k: {"count": r["count"], "device_ms": r["device_ms"],
            "device_ms_per_launch": r["device_ms"] / r["count"]}
        for r in rows for k in own if k in r["name"]
    }
    res = {
        "card": smi,
        "stages_median_s": median,
        "stages_runs": runs,
        "profiled_wall_s": wall,
        "device_busy_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "own_kernels": kernels,
        "top_device_ops": rows[:25],
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_torch_registration.json").write_text(json.dumps(res, indent=1))
    print(f"card: {smi}")
    print(json.dumps({k: res[k] for k in ("stages_median_s", "profiled_wall_s",
                                          "device_busy_ms", "device_busy_share",
                                          "own_kernels")}))
    for r in rows[:25]:
        print(f"{r['device_ms']:10.3f} ms  x{r['count']:<6d} {r['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
