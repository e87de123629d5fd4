#!/usr/bin/env python3
"""Phase 9d of ``chip_smoke.py`` over NCCL, one rank a card.

``chip_smoke.py`` runs its four ranks of spatial sharding as gloo processes
that share one card, which copies every halo through the host.  This script
runs the same ranks, the same grids and the same checks with
``init_distributed(backend="nccl")``, one rank a card, so that
``parallel/spatial.py:exchange_halo`` takes its ``batch_isend_irecv`` path
and the gathers go card to card:

* the 192^3 headline pair split along H over a (pair 1, space 4) grid, and
  two headline pairs over a (pair 2, space 2) grid, at the default config;
* every rank's fields equal to the one-process fields (registered here on
  card 0 first) to the bit, launches 2 / 2 / 15 / 80 a rank, each rank's
  recorded cost-volume and data-term calls held to their plain versions;
* each rank's card, seconds, peak memory and halo bytes.

Run it from the repository root on a host with four cards:
``python3 scripts/space_ranks_nccl.py``.  It prints each card's name and
power limit, a JSON line, and writes ``chiprun_out/space_ranks_nccl.json``.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import _build
    from convexadam_torch.pipeline.convex_adam import convex_adam

    n = torch.cuda.device_count()
    if n < cs.SPACE_RANKS:
        print(f"space_ranks_nccl: {n} cards, {cs.SPACE_RANKS} needed", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    for line in smi:
        print(f"card: {line}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    vol_np, mov_np = cs.headline_pair(torch, resize_trilinear)
    second = np.roll(vol_np, cs.PAIRED_SHIFTS[1], axis=(0, 1, 2))
    convex_adam(vol_np, mov_np, device="cuda")  # warm-up
    torch.cuda.reset_peak_memory_stats()
    lone = convex_adam(vol_np, mov_np, device="cuda")
    peak = torch.cuda.max_memory_allocated() / 1e9
    fields = [lone, convex_adam(vol_np, second, device="cuda")]
    results: dict = {"parallel": {}, "cards": smi}
    cs.PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    cs.space_phase(torch, vol_np, mov_np, fields, peak, results, backend="nccl")
    shutil.rmtree(cs.PARALLEL_DIR)
    results["seconds"] = time.perf_counter() - t0
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "space_ranks_nccl.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"space_ranks_nccl": results["parallel"]["9d_space"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
