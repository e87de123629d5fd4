#!/usr/bin/env python3
"""Host time per call of the port's sampler, data-term and cost-volume wrappers
on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/time_sampler_calls.py [--root DIR] [--calls 1000]

``--root`` imports ``convexadam_torch`` from another checkout (for example
an unpacked parent commit), so two versions of the wrapper can be compared
in one run of the card.  On inverse consistency's shape, 2 x 3 x 32^3
float32 fields sampled at a displaced identity grid, it times on the host
clock ``--calls`` calls of ``sample_trilinear`` and of ``F.grid_sample`` on
the same inputs, each run synchronized once at its end (so a time is what
the host spends issuing a call while the card keeps up), and one
``inverse_consistency`` call of 15 steps; and ``--calls`` calls of the Adam
data term ``warp_ssd_loss_grad`` on a 12 x 24^3 grid with bfloat16 moving
features (its launches take a few microseconds, so the host's issue time is
what the run measures), two readings, one before and one after the others;
and ``--calls`` calls of ``cost_volume`` on 12 x 8^3 features at the default
q = 4, likewise issue-bound.  It prints one JSON line with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    ap.add_argument("--calls", type=int, default=1000)
    args = ap.parse_args()
    sys.path.insert(0, str(args.root.resolve()))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import convexadam_torch
    from convexadam_torch.core.warp import identity_grid_normalized, inverse_consistency
    from convexadam_torch.kernels import _build
    from convexadam_torch.kernels.cost_volume import cost_volume
    from convexadam_torch.kernels.warp import sample_trilinear, warp_ssd_loss_grad

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    shape = (32, 32, 32)
    n = 32 ** 3
    gen = torch.Generator().manual_seed(0)
    fields = (torch.randn((2, 3) + shape, generator=gen) * 0.1).to(dev)
    ident = identity_grid_normalized(shape, False, device=dev).reshape(1, n, 3)
    grid = (ident + fields.flip(0).permute(0, 2, 3, 4, 1).reshape(2, n, 3)).contiguous()
    g5 = grid.flip(-1).reshape(2, 1, 1, n, 3)

    def host_us(fn, calls):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / calls * 1e6

    res = {"card": smi, "package": str(pathlib.Path(convexadam_torch.__file__).parent),
           "calls": args.calls}
    C, H = 12, 24
    ssd_fix = torch.rand((C, H ** 3), generator=gen).to(dev)
    ssd_mov = torch.rand((C, H, H, H), generator=gen).to(dev).to(torch.bfloat16)
    ssd_disp = (torch.randn((3, H, H, H), generator=gen) * 0.5).to(dev)
    fac = (H / (H - 1.0),) * 3

    def data_term():
        return warp_ssd_loss_grad(ssd_mov, ssd_disp, ssd_fix, fac, 2.0 * 12.0 / (C * H ** 3))

    res["warp_ssd_loss_grad_host_us"] = [host_us(data_term, args.calls)]
    # in turns: wrapper, library, library, wrapper
    runs = {"sample_trilinear": [], "grid_sample": []}
    for name in ("sample_trilinear", "grid_sample", "grid_sample", "sample_trilinear"):
        fn = ((lambda: sample_trilinear(fields, grid)) if name == "sample_trilinear"
              else (lambda: F.grid_sample(fields, g5, align_corners=False)))
        runs[name].append(host_us(fn, args.calls))
    res.update({f"{k}_host_us": v for k, v in runs.items()})
    res["inverse_consistency_15_host_us"] = host_us(
        lambda: inverse_consistency(fields[0], fields[1], 15), max(args.calls // 10, 1))
    res["warp_ssd_loss_grad_host_us"].append(host_us(data_term, args.calls))
    cv_fix, cv_mov = (torch.randn((12, 8, 8, 8), generator=gen).to(dev) for _ in range(2))
    res["cost_volume_host_us"] = host_us(lambda: cost_volume(cv_fix, cv_mov, 4), args.calls)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
