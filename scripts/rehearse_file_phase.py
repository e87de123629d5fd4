#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phase 6 (the file-level path) on the host CPU.

Run from the repository root, with no GPU:

    python3 scripts/rehearse_file_phase.py

It runs phases 6a-6f with CPU tensors at shrunken shapes (the masked pair
and the task driver at 40 x 36 x 48 with four box organs, the translation
case at 64 x 64 x 48 voxels, the small task at 32 x 24 x 32), so the kernel
wrappers run their plain versions: it checks the phase's files, control
flow and comparisons, not the kernels.  CUDA synchronisation and the launch
checks (CPU tensors launch nothing) are stubbed.  About two minutes on 4
threads; every time it prints is a host CPU time, not a card's.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _subjects():
    base = np.zeros(cs.ABDOMEN_SHAPE, np.int32)
    base[8:30, 6:28, 8:40] = 1
    base[12:20, 10:18, 12:20] = 2
    base[22:28, 20:26, 26:36] = 3
    base[10:14, 22:26, 30:38] = 4
    return np.stack([np.roll(base, s, axis=(0, 1, 2)) for s in cs.SWEEP_SHIFTS])


def main() -> int:
    torch.set_num_threads(4)
    torch.cuda.synchronize = lambda *a, **k: None
    cs._launch_checks = lambda what, launches, expected, at_least=(): print(
        f"  (CPU: no launches) expected on the card, {what}: "
        f"{ {k: v for k, v in expected.items() if v} }")
    cs.L2R_LABELS, cs.ABDOMEN_SHAPE = 4, (40, 36, 48)
    cs.FILE_CROP = 10
    cs.TRANSLATION_SIZE = (64, 64, 48)
    cs.L2R_SMALL_SHAPE = (32, 24, 32)
    cs.FILE_DIR = cs.OUT_DIR / "phase6_rehearsal"
    cs.sweep_subjects = _subjects
    results: dict = {}
    cs.file_phase(torch, torch.device("cpu"), results)
    print("phase 6 rehearsed on the CPU: every check but the stubbed launch counts held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
