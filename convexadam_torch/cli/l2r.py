"""CLI: Learn2Reg task driver (grid ablation → ranking → test submission).

Counterpart of ``convexadam_tpu/cli/l2r.py``, flag for flag, plus
``--device``; mirrors self_configuring/l2r3.py's CLI (:406-412).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser(description="L2R self-configuring driver")
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--task_name", required=True)
    parser.add_argument("--output_dir", default="./l2r_out")
    parser.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    parser.add_argument("--skip_testset", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ('cuda' or 'cpu')")
    args = parser.parse_args(argv)

    from convexadam_torch.selfconfig.l2r import (
        L2RTask,
        run_testset,
        run_validation_grid,
        select_winner,
    )

    task = L2RTask.load(args.data_dir, args.task_name)
    out = Path(args.output_dir)
    results = run_validation_grid(task, out / "validation", dtype=args.dtype, device=args.device)
    winner, agg = select_winner(results)
    print(f"WINNER: {winner} (rank {agg.max():.4f})")
    if not args.skip_testset and task.registration_test:
        written = run_testset(task, winner, out / "testset", dtype=args.dtype,
                              device=args.device)
        print(f"wrote {len(written)} test-set fields to {out / 'testset'}")


if __name__ == "__main__":
    main()
