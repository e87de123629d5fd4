#!/usr/bin/env python3
"""Readings that set the task-1 cell's own-field limits (``dice_gap``,
``sdlogj_gap``, ``map_gap``), at the cell's own size.

    python3 regbench/control_own.py --workload mrct-task1-val4 --seeds 11 12 13

For each seed it builds the cell's inputs, runs one call of the program,
and draws the pairs that a run's check would rescore.  It prints one JSON
line a seed: ``program``, the largest over those pairs of the gaps between
the call's scores and original-space fields and the reference's scores and
map of the call's own densified fields (a limit has to lie above the
largest); and ``control``, the smallest over those pairs of the gaps
between the reference's answers under those fields rounded to bfloat16,
the nearest precision below the configuration's, and under the fields as
they are (a limit has to lie below the smallest).  The benchmark's own runs
never run this.  Needs a CUDA card; the tests call :func:`readings` on the
CPU at a small size.
"""

from __future__ import annotations

import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(cell, seed: int, device) -> dict:
    """The program's own-field numbers and the control's for one seed."""
    inputs = cell.fixture().make(cell.config, seed, device)
    session = cell.entry().Session(cell, inputs, device)
    result = session.call()
    pairs = session.sample(seed)
    return {"seed": seed, "pairs": pairs, "program": session.own_gaps(result, pairs),
            "control": session.own_control(result, pairs)}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))
    import torch

    from rb.spec import load_cell

    if not torch.cuda.is_available():
        print("regbench control_own: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device("cuda"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
