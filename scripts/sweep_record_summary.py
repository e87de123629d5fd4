#!/usr/bin/env python3
"""One traced run of a benchmark cell, made as ``regbench/run.py --trace 1``
makes it, with the program's own record of each call in the window
(``SweepResult.spans`` and ``.counters``, ``convexadam_torch/utils/trace.py``)
split by span name.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/sweep_record_summary.py --workload <cell> --seed N [--seconds 30]

Prints the run's result line (per-layer metrics, device breakdown, checks)
and, a call on average: per span name its count, host seconds and stream
milliseconds; the ``sweep.prep`` children's host seconds; the stream time of
``sweep.convex`` a case and the share of it its ``convex.*`` children
cover; the counters.  Writes ``chiprun_out/record_<cell>_<seed>.json``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def summarize(results: list) -> dict:
    """Per-call means of the records of ``results`` (one a call)."""
    n = len(results)
    by: dict = {}
    counters: dict = {}
    parent_ms = child_ms = 0.0
    cases = set()
    for res in results:
        spans = res.spans
        for s in spans:
            e = by.setdefault(s.name, {"count": 0, "host_s": 0.0, "stream_ms": 0.0})
            e["count"] += 1
            e["host_s"] += (s.end_ns - s.start_ns) / 1e9
            e["stream_ms"] += s.stream_ms or 0.0
        for k, s in enumerate(spans):
            if s.name == "sweep.convex":
                cases.add(s.case)
                parent_ms += s.stream_ms or 0.0
                child_ms += sum(c.stream_ms or 0.0 for c in spans if c.parent == k)
        for key, v in res.counters.items():
            counters[key] = counters.get(key, 0) + v
    per_call = {name: {k: v / n for k, v in e.items()} for name, e in sorted(by.items())}
    per_case = n * max(len(cases), 1)
    return {
        "calls": n,
        "spans_per_call": per_call,
        "convex_stream_ms_per_case": parent_ms / per_case,
        "convex_children_cover": child_ms / parent_ms if parent_ms else None,
        "counters_per_call": {k: v / n for k, v in sorted(counters.items())},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "regbench"))
    sys.path.insert(0, str(ROOT))
    import run as bench_run
    from rb.harness import run_cell
    from rb.spec import load_cell

    bench_run._environment()
    cell = load_cell(ROOT, args.workload)
    session_type = cell.entry().Session
    window: list = []
    call = session_type.call

    def recorded_call(self, warm: bool = False):
        res = call(self, warm)
        if not warm:
            window.append(res)
        return res

    session_type.call = recorded_call
    line, checks = run_cell(cell, args.seed, args.seconds, True, "cuda", time.perf_counter())
    out = {"workload": args.workload, "seed": args.seed, "line": line,
           "correct": all(c.ok for c in checks),
           "checks": {c.name: [c.value, c.limit] for c in checks},
           "record": summarize(window)}
    print(json.dumps(out, indent=1), flush=True)
    dest = ROOT / "chiprun_out"
    dest.mkdir(exist_ok=True)
    (dest / f"record_{args.workload}_{args.seed}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
