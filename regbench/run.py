#!/usr/bin/env python3
"""Run one cell of the benchmark of ``convexadam_torch`` once.

    python3 regbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, on a machine
with the CUDA cards the cell asks for.  Prints the checks of what the
measured window produced (each number beside its limit) as the last lines
of standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``.  Exits with another code
than 0, printing no result, where the cards are missing, or where the run
loaded JAX or the JAX package.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (0 where /proc does not say)."""
    try:
        ticks = int(pathlib.Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(pathlib.Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_ORIGIN = time.perf_counter() - _process_age()

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def _environment() -> None:
    """Every cache of the program inside the checkout, at fixed paths;
    libraries kept from loading JAX by themselves."""
    build = ROOT / "build" / "regbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path.insert(0, str(BENCH))
    sys.path.insert(0, str(ROOT))
    import json

    import torch

    from rb.harness import run_cell
    from rb.imports import forbidden_modules
    from rb.spec import load_cell

    cell = load_cell(ROOT, args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"regbench: {args.workload} needs {chips} CUDA card(s), found {n}", file=sys.stderr)
        return 2
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_ORIGIN,
                            chips)
    found = forbidden_modules()
    if found:
        print(f"regbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    out = {"correct": all(c.ok for c in checks), **line,
           "checks": {c.name: {"value": c.value, "limit": c.limit} for c in checks}}
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
