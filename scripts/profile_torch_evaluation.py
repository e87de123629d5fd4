#!/usr/bin/env python3
"""Where the time of one Learn2Reg evaluation goes on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/profile_torch_evaluation.py [--runs 3] [--root DIR]

``--root`` imports ``convexadam_torch`` from another checkout (for example an
unpacked parent commit), so two versions can be profiled in one run of the
card, in turns; the inputs always come from this checkout's
``chip_smoke.py``.

It registers the 192^3 headline pair of ``chip_smoke.py`` (seed 0, shift
(5, -4, 3), default config) and scores the field on ``chip_smoke.py``'s
13-organ label pair, reporting

* ``evaluate_field`` itself on the host clock (median of ``--runs`` after a
  warm-up);
* one ``evaluate_field`` under ``torch.profiler``, split by the
  ``record_function`` ranges of the entry (``evaluate_field.*``: Jacobian
  metrics, label warp + Dice, HD95, keypoint TRE; inside HD95, ``hd95.*``:
  the host cap sizing with the copies of both label volumes, the surface
  lists and label buffers, the per-label searches and percentiles): each
  range's host time and the device time of the kernels launched inside it.
  A range's host time includes any wait for the card inside it; a range
  that ends without a wait hands its device work on to the next.
* the same trace's device time by kernel name (the search kernels listed
  apart, per launch) and the device-busy share (summed device time over
  the profiled wall time);
* the search launches of each label bucket (each call of
  ``hd95_from_buffers``) in one evaluation, and the ``hd95.searches``
  range's host time.

It prints a JSON line and writes ``chiprun_out/profile_torch_evaluation.json``.
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
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    args = ap.parse_args()
    # the inputs come from this checkout, the package from --root
    from chip_smoke import HEADLINE_SHIFT, L2R_LABELS, L2R_MARGIN, headline_pair, l2r_label_pair

    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from convexadam_torch import evaluate_field
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import _build
    from convexadam_torch.pipeline.convex_adam import convex_adam

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    vol_np, mov_np = headline_pair(torch, resize_trilinear)
    field = convex_adam(vol_np, mov_np, device="cuda")
    seg_f, seg_m = l2r_label_pair()
    rng = np.random.default_rng(1)
    kf = rng.uniform(L2R_MARGIN, seg_f.shape[0] - L2R_MARGIN, (20, 3)).astype(np.float32)
    km = kf + np.asarray(HEADLINE_SHIFT, np.float32)

    def evaluate():
        return evaluate_field(field, seg_f, seg_m, L2R_LABELS, kf, km, device="cuda")

    import convexadam_torch.core.edt as tedt
    from convexadam_torch.kernels import LAUNCHES

    evaluate()  # warm-up
    # the search launches of each label bucket: one hd95_from_buffers call each
    per_bucket = []
    from_buffers = tedt.hd95_from_buffers

    def counted(bufs, caps, K, *a, **k):
        before = dict(LAUNCHES)
        out = from_buffers(bufs, caps, K, *a, **k)
        per_bucket.append({"K": K, "launches": {
            n: LAUNCHES[n] - before[n] for n in ("nearest_sq", "nearest_sq_dual",
                                                  "nearest_sq_pruned") if LAUNCHES[n] > before[n]}})
        return out

    tedt.hd95_from_buffers = counted
    try:
        evaluate()
    finally:
        tedt.hd95_from_buffers = from_buffers
    ev_times = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        evaluate()
        ev_times.append(time.perf_counter() - t0)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages = {}
    rows = []
    device_us = 0.0
    for e in prof.key_averages():
        if e.key.startswith(("evaluate_field.", "hd95.")):
            if e.device_type == torch.autograd.DeviceType.CPU:
                stages[e.key] = {"host_ms": e.cpu_time_total / 1e3,
                                 "device_ms": e.device_time_total / 1e3}
            continue
        # device events only (kernels, memcpy, memset), as in
        # scripts/profile_torch_registration.py
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        dev_us = e.self_device_time_total
        rows.append({"name": e.key[:90], "count": e.count, "device_ms": dev_us / 1e3})
        device_us += dev_us
    rows.sort(key=lambda r: -r["device_ms"])
    own = ("nearest_sq_kernel", "nearest_sq_dual_kernel", "nearest_sq_pruned_kernel")
    kernels = {
        k: {"count": r["count"], "device_ms": r["device_ms"],
            "device_ms_per_launch": r["device_ms"] / r["count"]}
        for r in rows for k in own if f"{k}(" in r["name"]
    }
    res = {
        "card": smi,
        "package": str(pathlib.Path(tedt.__file__).parents[1]),
        "launches_per_bucket": per_bucket,
        "hd95_searches_host_ms": stages.get("hd95.searches", {}).get("host_ms"),
        "evaluate_field_s_median": float(np.median(ev_times)),
        "evaluate_field_s": ev_times,
        "stages": stages,
        "profiled_wall_s": wall,
        "device_busy_ms": device_us / 1e3,
        "device_busy_share": device_us / 1e6 / wall,
        "own_kernels": kernels,
        "top_device_ops": rows[:25],
    }
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_torch_evaluation.json").write_text(json.dumps(res, indent=1))
    print(f"card: {smi}")
    print(json.dumps({k: res[k] for k in ("package", "evaluate_field_s_median", "stages",
                                          "launches_per_bucket", "hd95_searches_host_ms",
                                          "profiled_wall_s",
                                          "device_busy_ms", "device_busy_share",
                                          "own_kernels")}))
    for r in rows[:25]:
        print(f"{r['device_ms']:10.3f} ms  x{r['count']:<6d} {r['name']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
