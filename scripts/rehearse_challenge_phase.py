#!/usr/bin/env python3
"""Rehearse ``chip_smoke.py``'s phase 7 (the challenge recipes, the streamed
convex path, the strided data term, the kernels at the recipes' shapes) and
its phase 3b/3d variant cases on the host CPU.

Run from the repository root, with no GPU:

    python3 scripts/rehearse_challenge_phase.py

It runs them with CPU tensors at shrunken shapes (task 1 at 48 x 40 x 48,
task 2 at 48 x 48 x 52, task 3 at 40 x 48 x 56 with 12 labels, CuRIOUS on
case 1's landmarks cropped with a 20-voxel margin, the streamed class on
40 x 36 x 48 subjects with the dense threshold lowered so that a 48 x 48 x
56 pair streams, the strided registration at 48^3), so the kernel wrappers
run their plain versions: it checks the phase's control flow and
comparisons, not the kernels.  CUDA synchronisation, memory statistics,
the profiler, the timers and the launch checks (CPU tensors launch
nothing) are stubbed.  About two minutes on 4 threads; every time it
prints is a host CPU time, not a card's.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from convexadam_torch.core import convex  # noqa: E402
from convexadam_torch.kernels import KERNEL_NAMES  # noqa: E402


def _fake_times(torch_, fn, kernels=None, warmup=3, reps=20):
    fn()
    return {"device_ms": 0.0, "device_all_ms": 0.0, "device_launches": 1}


def _fake_turns(torch_, kern, kernels, lib=None):
    kern()
    return {"readings": {}, "call_ms": 0.0, "device_ms": 0.0, "device_all_ms": 0.0,
            "library_call_ms": None, "library_device_ms": None, "library_device_all_ms": None,
            "device_launches": 1}


def _box_pair(shape=None, shift=cs.HEADLINE_SHIFT, **_):
    """Four box organs scaled to ``shape`` and their roll by ``shift``."""
    base = np.zeros(shape, np.int32)
    for k, (lo, hi) in enumerate(((0.2, 0.6), (0.3, 0.5), (0.55, 0.75), (0.25, 0.4)), start=1):
        box = tuple(slice(int(lo * n) + k, int(hi * n) + k) for n in shape)
        base[box] = k
    return base, np.roll(base, shift, axis=(0, 1, 2))


def _cropped_curious_inputs(torch_, dev_, case=cs.CURIOUS_CASE, margin=20):
    """``chip_smoke.curious_inputs`` on the landmark clouds' box grown by
    ``margin`` voxels on every side."""
    segs, cen_u, cen_m = cs.curious_landmarks(case)
    pts = np.argwhere((segs[0] > 0) | (segs[1] > 0))
    lo = np.maximum(pts.min(0) - margin, 0)
    hi = np.minimum(pts.max(0) + margin + 1, segs[0].shape)
    box = tuple(slice(a, b) for a, b in zip(lo, hi))
    return cs.curious_volumes(torch_, dev_, [seg[box].copy() for seg in segs], cen_u - lo,
                              cen_m - lo)


def main() -> int:
    torch.set_num_threads(4)
    dev = torch.device("cpu")
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.memory_allocated = lambda *a, **k: 0
    cs.device_times, cs.timed_turns = _fake_times, _fake_turns
    cs.cuda_ms = lambda torch_, fn, warmup=3, reps=20: (fn(), 0.0)[1]
    cs._launch_checks = lambda what, launches, expected, at_least=(): print(
        f"  (CPU: no launches) expected on the card, {what}: "
        f"{ {k: v for k, v in expected.items() if v} }")
    cs.COST_VOLUME_TASK3, cs.COST_VOLUME_TASK1 = (36, 10, 12, 14), (12, 6, 5, 6)
    cs.COST_VOLUME_STREAM, cs.COST_VOLUME_SEMANTIC = (14, 12, 10, 16), (14, 8, 6, 10)
    cs.TASK1_SHAPE, cs.TASK1_ORIGINAL = (48, 40, 48), ((60, 50, 60), (1.6, 1.6, 1.6))
    cs.TASK2_SHAPE, cs.TASK3_SHAPE = (48, 48, 52), (40, 48, 56)
    cs.TASK3_LABELS, cs.TASK3_SCALE = 12, 8
    cs.ABDOMEN_SHAPE, cs.L2R_LABELS, cs.SEMANTIC_LABELS = (40, 36, 48), 4, 5
    cs.STREAM_NATURAL_SHAPE = (48, 48, 56)
    k3 = (2 * cs.STREAM_CLASS[1] + 1) ** 3
    threshold = k3 * 20 * 18 * 24 * 8  # the subjects' grid, dense
    convex.COST_VOLUME_STREAM_THRESHOLD = threshold
    # convex_displacement's default was bound when the module loaded
    code = convex.convex_displacement.__code__
    defaults = list(convex.convex_displacement.__defaults__)
    names = code.co_varnames[code.co_argcount - len(defaults):code.co_argcount]
    defaults[names.index("stream_threshold")] = threshold
    convex.convex_displacement.__defaults__ = tuple(defaults)
    cs.HEADLINE_SHAPE = (48, 48, 48)
    cs.curious_inputs = _cropped_curious_inputs
    cs.l2r_label_pair = _box_pair
    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.pipeline.convex_adam import convex_adam

    records, detail = cs.cost_volume_variant_phase(torch, dev)
    print(f"3b variants: {sorted(records)}, {len(detail)} cases")
    vol, mov = cs.headline_pair(torch, resize_trilinear, shape=cs.HEADLINE_SHAPE)
    feat_f = mindssc(torch.from_numpy(vol), 1, 2)
    feat_m = mindssc(torch.from_numpy(mov), 1, 2)
    gen = torch.Generator().manual_seed(0)
    rec, rows = cs.data_term_phase(torch, gen, feat_f, feat_m, 2)
    print(f"3d: {rec['name']}, {len(rows)} cases")
    rec, rows = cs.strided_data_term_phase(torch, gen, feat_f, feat_m, 2)
    print(f"3d strided: {rec['name']} (strides 2 and {rec['at_stride_3']['stride']}), "
          f"{len(rows)} cases")
    single = convex_adam(vol, mov, device=dev)
    results: dict = {}
    records = [{"name": name} for name in KERNEL_NAMES]
    launches = cs.challenge_phase(torch, dev, vol, mov, single, records, results)
    print("7g readings:", {r["name"]: len(r["at_challenge_shape"]) for r in records
                           if "at_challenge_shape" in r})
    print(f"phase 7 rehearsed on the CPU ({sorted(launches)}): every check but the stubbed "
          "launch counts held")
    return 0


if __name__ == "__main__":
    sys.exit(main())
