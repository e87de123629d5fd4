#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phase 5 (the sweep) on the host CPU.

Run from the repository root, with no GPU:

    python3 scripts/rehearse_sweep_phase.py

It runs phases 5a-5f with CPU tensors at shrunken shapes (four box-shaped
organs in 40 x 36 x 48, MIND pairs at 48^3, 5f's protocol fixture of 10
subjects at 24 x 20 x 32), so the kernel wrappers run
their plain versions and meet themselves: it checks the phases' control
flow, shapes, checkpoint round trip and comparisons, not the kernels.  CUDA
synchronisation, peak memory, the launch checks (CPU tensors launch
nothing) and the timing helpers are stubbed, and HD95 takes the device
engine as it does on the card.  About three and a half minutes on 4 threads;
every time it prints is a host CPU time, not a card's.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import convexadam_torch.selfconfig.engine as teng  # noqa: E402


def _ms(torch_, fn, warmup=0, reps=1):
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def _subjects():
    base = np.zeros(cs.ABDOMEN_SHAPE, np.int32)
    base[8:30, 6:28, 8:40] = 1
    base[12:20, 10:18, 12:20] = 2
    base[22:28, 20:26, 26:36] = 3
    base[10:14, 22:26, 30:38] = 4
    return np.stack([np.roll(base, s, axis=(0, 1, 2)) for s in cs.SWEEP_SHIFTS])


def main() -> int:
    torch.set_num_threads(4)
    for name in ("synchronize", "reset_peak_memory_stats"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = torch.cuda.memory_allocated = lambda *a, **k: 0
    cs._launch_checks = lambda what, launches, expected, at_least=(): print(
        f"  (CPU: no launches) expected on the card, {what}: "
        f"{ {k: v for k, v in expected.items() if v} }")
    cs.cuda_ms = _ms
    cs.timed_turns = lambda torch_, kern, kernels, lib=None: {
        "call_ms": _ms(torch_, kern), "device_ms": 0.0, "library_call_ms": None,
        "library_device_ms": None, "device_launches": 0, "readings": {}}
    cs.L2R_LABELS, cs.ABDOMEN_SHAPE, cs.HEADLINE_SHAPE = 4, (40, 36, 48), (48, 48, 48)
    cs.PAIRED_SHIFTS = ((2, -1, 1), (-1, 2, 1))
    cs.PROTOCOL_SHAPE = (24, 20, 32)
    cs.sweep_subjects = _subjects
    resolve = teng._resolve_hd95_mode
    teng._resolve_hd95_mode = lambda mode, shape, dev: resolve(mode or "device", shape, dev)
    cs.OUT_DIR.mkdir(exist_ok=True)

    dev, card, results = torch.device("cpu"), "host CPU rehearsal", {}
    records = [{"name": n} for n in cs.GLOBALS]
    segs = cs.sweep_subjects()
    settings, first, _, field25 = cs.sweep_stage1_phase(torch, dev, segs, card, results)
    adam, _ = cs.sweep_stage2_phase(torch, dev, segs, settings[first.best], card, results)
    cs.sweep_paired_phase(torch, dev, adam[cs.SWEEP_ADAM_GRIDS.index(2)], card, results)
    cs.sweep_resume_phase(torch, dev, segs, settings, first, results)
    cs.sweep_kernel_phase(torch, dev, segs, settings, field25, records, results)
    cs.protocol_phase(torch, dev, card, records, results)
    print("phase 5 rehearsed on the CPU: every check but the stubbed launch counts held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
