#!/usr/bin/env python3
"""Device time of the coupled argmin fold at every launch shape, on a CUDA
card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/time_coupled_fold.py [--check]

At each (n, q) class of ``chip_smoke.py``'s ``FOLD_CLASSES`` (every class of
the benchmark's two cells, task 1's q = 8, a ragged voxel count), on
``chip_smoke.fold_inputs``, it times one launch of
``coupled_argmin_fold_kernel`` at every (vec, splits) the entry takes
(``kernels/convex.py:_launch``; vec 4 only where the rows allow 16-byte
loads) and marks the one ``launch_plan`` chooses: the device time a launch
(``torch.profiler``, ``chip_smoke.device_times``), the bound (K^3 n 4 bytes
at 3.35 TB/s) and its share of the time.  ``--check`` first holds every
shape to the plain version at the class (c = 0.03), to the bit.  It ends
with one JSON line with the card's name and power limit and writes the
table to ``chiprun_out/coupled_fold_plans.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from convexadam_torch.kernels import _build
    from convexadam_torch.kernels import convex as fold

    if not torch.cuda.is_available():
        print("time_coupled_fold: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.build_all(("convex",))
    print(json.dumps({"ptxas": _build.resource_usage("convex")}), flush=True)
    rows = []
    for n, q in cs.FOLD_CLASSES:
        costs, mesh, s = cs.fold_inputs(torch, dev, n, q, seed=n + q)
        k = costs.shape[0]
        idx = torch.arange(k, device=dev)
        best = torch.full((n,), float("inf"), device=dev)
        bidx = torch.full((n,), k, dtype=torch.int64, device=dev)
        chosen = fold.launch_plan(n, k, n % 4 == 0, fold.sm_count(dev))
        bound = cs.fold_work(k, n)[0] / cs.PEAK_BYTES_S * 1e3
        want = None
        if args.check:
            want = cs._fold(torch, fold.coupled_argmin_fold_plain, costs, mesh, s, 0.03)
        for vec in (1, 4) if n % 4 == 0 else (1,):
            for splits in fold.SPLITS:
                def launch(vec=vec, splits=splits, c=1.0, b=best, i=bidx):
                    fold._launch(costs, mesh, idx, s, c, b, i, vec, splits)

                if want is not None:
                    b = torch.full((n,), float("inf"), device=dev)
                    i = torch.full((n,), k, dtype=torch.int64, device=dev)
                    launch(c=0.03, b=b, i=i)
                    cs.check(cs._same_fold(torch, (b, i), want),
                             f"{k}x{n} vec {vec} splits {splits}: differs from the plain fold")
                t = cs.device_times(torch, launch, cs.FOLD_GLOBALS["coupled_argmin"], 2, 10)
                row = {"k": k, "n": n, "q": q, "vec": vec, "splits": splits,
                       "chosen": (vec, splits) == chosen, "device_ms": t["device_ms"],
                       "bound_ms": bound, "bound_share": bound / t["device_ms"]}
                rows.append(row)
                print(f"{k:5d} x {n:8d} vec {vec} splits {splits}: {t['device_ms']:.4f} ms, "
                      f"bound {bound:.4f} ms, {100 * row['bound_share']:.1f}%"
                      + ("  <- launch_plan" if row["chosen"] else ""), flush=True)
        del costs, mesh, s, best, bidx
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "coupled_fold_plans.json").write_text(json.dumps(rows, indent=1))
    print(json.dumps({"card": smi, "checked": args.check, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
