#!/usr/bin/env python3
"""Readings that set a cell's limits: the precision control, and with
``--program`` the program's own readings, at the cell's own size.

    python3 regbench/control.py --workload <cell> --seeds 11 12 13 [--program]

For each seed it builds the cell's inputs, draws the cases (or settings)
that a run's check would recompute, and computes them with the plain
reference twice: in the configuration's float32, and in bfloat16, the
nearest precision below, put in the program's place.  It prints one JSON
line a seed with the numbers a run compares (``control``), each the gap
between the bfloat16 and the float32 reference; a limit has to lie below
the smallest of them.  With ``--program`` it also runs one call of the
program's sweep and prints the same numbers for it against the float32
reference (``program``); a limit has to lie above the largest.  The
benchmark's own runs never run this.  Needs a CUDA card; the tests call
:func:`readings` on the CPU at a small size.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def readings(cell, seed: int, device, program: bool) -> dict:
    """The control's numbers (and the program's) for one seed."""
    import torch

    entry = cell.entry()
    inputs = cell.fixture().make(cell.config, seed, device)
    session = entry.Session(cell, inputs, device)
    out: dict = {"seed": seed}
    result = session.call() if program else None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = session.reference(seed, torch.float32)
    out["reference_s"] = time.perf_counter() - t0
    low = session.reference(seed, torch.bfloat16, keys=list(ref))
    out["control"] = session.gaps(low, ref)
    if result is not None:
        out["program"] = {c.name: c.value for c in session.judge([result], seed, reference=ref)}
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))
    import torch

    from rb.spec import load_cell

    if not torch.cuda.is_available():
        print("regbench control: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, dev, args.program)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
