#!/usr/bin/env python3
"""Shift recovery of the semantic registration inside the organs, one pair
registered several ways.

Builds ``chip_smoke.py``'s 13-organ label pair (phase 4d: the Abdomen CT-CT
shape 192 x 160 x 256, a 12-voxel margin, moving = fixed rolled by the shift
(5, -4, 3)) and registers it with the default config once per ``--runs``
entry, each ``package-device-dtype``:

* ``torch-cuda-bf16``: the port on the card, as phase 4d runs it;
* ``torch-cuda-f32``: the same in float32;
* ``torch-cpu-f32``: the port's plain PyTorch path (the one the CPU tests
  hold against the JAX package);
* ``jax-cpu-f32``: the JAX package on the CPU (needs ``jax``).

For each it prints the share of the organ voxels whose displacement is
within 1 and within 2 voxels of the shift on every axis, the per-axis mean
error, the seconds taken, and the field's distance from the first run's.

    python3 scripts/semantic_shift_share.py                      # full size, all four
    python3 scripts/semantic_shift_share.py --shape 96 80 128 --large-axes 14 18 \\
        --runs torch-cpu-f32 jax-cpu-f32                          # half size, CPU only

Each run's peak host memory is printed beside its time (the process's
high-water mark so far); run the full-size CPU runs on a host with memory to
spare.  It prints a JSON line and writes
``chiprun_out/semantic_shift_share.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import resource
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

RUNS = ("torch-cuda-bf16", "torch-cuda-f32", "torch-cpu-f32", "jax-cpu-f32")


def register(run: str, seg_f: np.ndarray, seg_m: np.ndarray) -> np.ndarray:
    """The field (H, W, D, 3) of one ``package-device-dtype`` run."""
    package, device, dtype = run.split("-")
    dtype = {"f32": "float32", "bf16": "bfloat16"}[dtype]
    if package == "torch":
        import torch

        from convexadam_torch import convex_adam_semantic_torch
        from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

        out = convex_adam_semantic_torch(
            seg_f, seg_m, ConvexAdamConfig(dtype=dtype), num_labels=chip_smoke.SEMANTIC_LABELS,
            device=device,
        )
        if device == "cuda":
            torch.cuda.synchronize()
        return out.cpu().numpy()
    os.environ["JAX_PLATFORMS"] = device  # before the first import of jax
    import jax
    import jax.numpy as jnp

    from convexadam_tpu.pipeline.convex_adam import ConvexAdamConfig, convex_adam_semantic_jax

    if jax.devices()[0].platform != device:
        raise RuntimeError(f"jax runs on {jax.devices()[0].platform}, not {device}")
    return np.asarray(convex_adam_semantic_jax(
        jnp.asarray(seg_f), jnp.asarray(seg_m), ConvexAdamConfig(dtype=dtype),
        num_labels=chip_smoke.SEMANTIC_LABELS,
    ))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3, default=chip_smoke.ABDOMEN_SHAPE)
    ap.add_argument("--large-axes", type=int, nargs=2, default=chip_smoke.L2R_LARGE_AXES,
                    help="semi-axis range of the liver-sized organ")
    ap.add_argument("--runs", nargs="+", choices=RUNS, default=RUNS)
    args = ap.parse_args()
    shape = tuple(args.shape)
    seg_f, seg_m = chip_smoke.l2r_label_pair(shape=shape, margin=chip_smoke.ABDOMEN_MARGIN,
                                             large_axes=tuple(args.large_axes))
    organs = seg_f > 0
    shift = np.asarray(chip_smoke.HEADLINE_SHIFT, np.float32)
    res = {"shape": list(shape), "large_axes": list(args.large_axes),
           "organ_voxels": int(organs.sum()), "runs": {}}
    if any("cuda" in r for r in args.runs):
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    first = None
    for run in args.runs:
        t0 = time.perf_counter()
        out = register(run, seg_f, seg_m)
        secs = time.perf_counter() - t0
        err = np.abs(out[organs] - shift)
        r = {
            "seconds": secs,
            "host_peak_rss_gb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
            "frac_within_1vox": float(np.all(err < 1.0, axis=-1).mean()),
            "frac_within_2vox": float(np.all(err < 2.0, axis=-1).mean()),
            "mean_abs_err_vox_per_axis": err.mean(0).tolist(),
        }
        if first is None:
            first = out
        else:
            d = np.abs(out - first)
            r[f"vs_{args.runs[0]}"] = {
                "max_abs_diff_vox": float(d.max()), "mean_abs_diff_vox": float(d.mean()),
                "organ_frac_diff_over_half_vox": float(np.any(d[organs] > 0.5, axis=-1).mean()),
            }
        res["runs"][run] = r
        print(run, json.dumps(r), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "semantic_shift_share.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
