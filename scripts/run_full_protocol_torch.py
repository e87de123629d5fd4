#!/usr/bin/env python3
"""The reference's whole self-configuring protocol on one CUDA card, in one
process: 100 seeded stage-1 settings x the reference's 8 pairs on the
13-organ sweep fixture at 192 x 160 x 256, then 75 seeded stage-2 settings
from stage 1's winner, each scored as 16 variants.

Counterpart of ``scripts/run_full_protocol.py`` (the JAX package's), with
its flags and ``--device``.  Run from the repository root:

    python3 scripts/run_full_protocol_torch.py [--settings1 100] [--settings2 75] \\
        [--checkpoint DIR [--resume]] [--device cuda]

It prints each setting's line as it finishes, one JSON line a stage and one
for the total (``convexadam_torch.selfconfig.protocol.run_full_protocol``),
each kernel's launches over both stages, then the per-class table
(``summarize_protocol_log``).  With
``--checkpoint DIR`` both stages checkpoint under ``DIR`` after every
setting and the log is appended to ``DIR/protocol.log``; on the card each
setting's line is followed by the memory still allocated and reserved; a run stopped
part-way continues with ``--resume`` (its minutes then span the runs; each
run's own are in its lines), and the table is that of the whole log.  The
card's name and power limit are printed first, as ``nvidia-smi`` reads them.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class _Tee(io.TextIOBase):
    """Writes through to ``out``, keeps every line, and appends each to the
    file ``log`` when one is given.  After each setting's line it adds one
    line of ``note()`` (the card's memory) when ``note`` is given."""

    def __init__(self, out, log: "pathlib.Path | None", note=None):
        self.out, self.log, self.note, self.lines, self._part = out, log, note, [], ""

    def write(self, s: str) -> int:
        *done, self._part = (self._part + s).split("\n")
        for line in done:
            self._line(line)
            if self.note is not None and line.startswith("s="):
                self._line(self.note())
        return len(s)

    def _line(self, line: str) -> None:
        self.out.write(line + "\n")
        self.lines.append(line)
        if self.log is not None:
            with open(self.log, "a") as f:
                f.write(line + "\n")

    def flush(self) -> None:
        self.out.flush()


def _memory() -> str:
    """The card's memory after a setting: what stays allocated, and the
    caching allocator's pool (growth from setting to setting is a fault)."""
    import torch

    return (f"  memory: allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB, reserved "
            f"{torch.cuda.memory_reserved() / 1e9:.3f} GB")


def _card(dev) -> str:
    import torch

    if dev.type != "cuda":
        return f"device {dev}"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return f"{smi[0]} ({torch.cuda.get_device_name(0)})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--settings1", type=int, default=100)
    ap.add_argument("--settings2", type=int, default=75)
    ap.add_argument("--checkpoint", default=None,
                    help="directory for both stages' checkpoints and the log; with --resume a "
                         "stopped run continues, skipping completed settings")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from convexadam_torch import _resolve_device
    from convexadam_torch.kernels import LAUNCHES, reset_launches
    from convexadam_torch.selfconfig.protocol import (
        REF_PAIRS,
        make_sweep_fixture,
        run_full_protocol,
        summarize_protocol_log,
    )

    dev = _resolve_device(args.device)  # no card: raise before any work

    log = None
    if args.checkpoint:
        log = pathlib.Path(args.checkpoint) / "protocol.log"
        log.parent.mkdir(parents=True, exist_ok=True)
        if not args.resume:
            log.unlink(missing_ok=True)
    tee = _Tee(sys.stdout, log, _memory if dev.type == "cuda" else None)
    with contextlib.redirect_stdout(tee):
        print(f"card: {_card(dev)}", flush=True)
        t0 = time.perf_counter()
        segs, L = make_sweep_fixture()
        print(f"fixture: {segs.shape[0]} subjects at {segs.shape[1:]}, {L} labels, "
              f"{time.perf_counter() - t0:.2f} s on the host", flush=True)
        reset_launches()
        run_full_protocol(segs, segs, REF_PAIRS, L, n1=args.settings1, n2=args.settings2,
                          checkpoint=args.checkpoint, resume=args.resume, verbose=True,
                          device=dev)
        print(f"kernel launches, both stages: {dict(LAUNCHES)}", flush=True)
    lines = log.read_text().splitlines() if log is not None else tee.lines
    for row in summarize_protocol_log(lines):
        print(row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
