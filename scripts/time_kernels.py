#!/usr/bin/env python3
"""Device and call times of the MIND, cost-volume, sampler and data-term
kernels on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/time_kernels.py [--root DIR] [--check] [--sass]

``--root`` imports ``convexadam_torch`` from another checkout (for example
an unpacked parent commit), so two versions of the kernels can be timed in
one run of the card, in turns.  On inputs from ``chip_smoke.py``'s own case
generators (``mind_cases``, ``cost_volume_cases``, ``adam_sampler_cases`` and
``data_term_cases`` of this checkout, seed 0) it times
``mind_ssd_stats`` (the 192^3 headline volume in bfloat16, r = 1, d = 2),
``cost_volume`` (the default 12 x 32^3 at q = 4, the semantic grid 14 x 32
x 26 x 42 at q = 4 and the sweep's 12 x 64 x 53 x 85 at q = 7),
``sample_trilinear`` (the semantic Adam grid 14 x 96 x 80 x 128 with
bfloat16 and float32 volumes, with ``F.grid_sample`` on the float32 volume
beside it) and ``warp_ssd_loss_grad`` (the 12 x 96^3 Adam grid with
bfloat16 and float32 moving features, and the semantic Adam grid in
bfloat16) with ``chip_smoke.py``'s two figures: ``call_ms``, the median
CUDA-event time of one wrapper call, and ``device_ms``, the device time per
call of every kernel the call runs (``torch.profiler``).  It prints one
JSON line with the card's name and power limit.

``--check`` first runs ``chip_smoke.py``'s ptxas report (registers and
spills of ``mind.cu``, ``warp.cu`` and ``cost_volume.cu``) and its phases
3a, 3b, 3c's sampler, 3d and 3f on this checkout's package (every
comparison to the bit): the short first call for an edited kernel.
``--sass`` also counts the machine instructions (``cuobjdump -sass``) of
the compile-time MIND kernels, the data term, the sampler and the
cost-volume kernels as built for ``--root``; in the fully unrolled MIND
kernels that is close to what a thread executes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    if args.check and args.root.resolve() != ROOT:
        ap.error("--check runs this checkout's phases on this checkout's package only")
    # the inputs and timing helpers come from this checkout, the package from --root
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import convexadam_torch
    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import _build
    from convexadam_torch.kernels.cost_volume import cost_volume
    from convexadam_torch.kernels.mind import mind_ssd_stats
    from convexadam_torch.kernels.warp import sample_trilinear, warp_ssd_loss_grad

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all()
    dev = torch.device("cuda")
    res = {"card": smi, "package": str(pathlib.Path(convexadam_torch.__file__).parent)}
    vol_np, mov_np = cs.headline_pair(torch, resize_trilinear)
    vol = torch.from_numpy(vol_np).to(dev)
    feats = [mindssc(torch.from_numpy(v).to(dev), 1, 2, dtype=torch.bfloat16)
             for v in (vol_np, mov_np)]

    # the main path's cost-volume inputs: the MIND features pooled by grid_sp 6
    fix_s, mov_s = (avg_pool3d(f, 6).float().contiguous() for f in feats)

    if args.check:
        cs.ptxas_report(_build)
        _, res["mind_check"] = cs.mind_phase(torch, vol)
        _, res["cost_volume_check"] = cs.cost_volume_phase(torch, fix_s, mov_s, 4)
        gen = torch.Generator().manual_seed(0)
        _, res["sampler_check"] = cs.sampler_phase(torch, dev, gen, tuple(fix_s.shape[1:]))
        _, res["data_term_check"] = cs.data_term_phase(torch, gen, *feats, 2)
        _, res["sampler_bwd_check"] = cs.sampler_bwd_phase(torch, dev, gen)

    if args.sass:
        cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
        res["sass_instructions"] = {}
        for src, kernel in (("mind", "mind_kernel"), ("warp", "warp_ssd_kernel"),
                            ("warp", "sample_trilinear_kernel"), ("cost_volume", "cost_volume")):
            sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(src))],
                                  capture_output=True, text=True, check=True).stdout
            for body in re.split(r"\n\s+Function : ", sass)[1:]:
                name = body.split("\n", 1)[0].strip()
                if kernel in name:
                    res["sass_instructions"][name] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s", body))

    def timed(fn):
        t = {"call_ms": cs.cuda_ms(torch, fn), **cs.device_times(torch, fn)}
        return {k: t[k] for k in ("call_ms", "device_ms", "device_launches")}

    shape, dt, r, d, x = next(cs.mind_cases(torch, vol))
    res[f"mind_ssd_stats {shape} {dt} (r, d) = {(r, d)}"] = timed(lambda: mind_ssd_stats(x, r, d))
    for what, q, fix, mov in cs.cost_volume_cases(torch, fix_s, mov_s, 4):
        if what == "ragged":
            break
        res[f"cost_volume {what} {tuple(fix.shape)} q={q}"] = timed(lambda: cost_volume(fix, mov, q))
    gen = torch.Generator().manual_seed(0)
    for C, shape, dt, svol, grid, _ in cs.adam_sampler_cases(torch, dev, gen):
        if C == cs.SEMANTIC_LABELS:
            res[f"sample_trilinear {(1, C, *shape)} {dt}"] = timed(lambda: sample_trilinear(svol, grid))
            if dt == torch.float32:
                g5 = grid.flip(-1).reshape(1, 1, 1, -1, 3)
                res[f"F.grid_sample {(1, C, *shape)} {dt}"] = timed(
                    lambda: F.grid_sample(svol, g5, align_corners=False))
    gen = torch.Generator().manual_seed(0)
    for what, fix, mov, disp, fac, chain in cs.data_term_cases(torch, gen, *feats, 2):
        if what != "ragged":
            res[f"warp_ssd_loss_grad {what} {tuple(mov.shape)} {mov.dtype}"] = timed(
                lambda: warp_ssd_loss_grad(mov, disp, fix, fac, chain))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
