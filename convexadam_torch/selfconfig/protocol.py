"""The reference's whole self-configuring protocol in one process: stage 1
over ``n1`` seeded convex settings, then stage 2 from its winner over ``n2``
seeded Adam settings, each scored as 16 variants.

Counterpart of the JAX repository's ``scripts/run_full_protocol.py`` (the
two stages), ``bench.py:51-105`` (the sweep fixture and the reference's pairs)
and ``scripts/summarize_protocol_log.py`` (the per-class table).  The
reference workload (README "usually run in 1 hour or less" on its GPU):
stage 1 is convex_run_withconfig.py, 100 seeded settings x 8 pairs at
192 x 160 x 256 with Dice, robust-30 Dice, SDlogJ and HD95 per case; stage 2
is adam_run_withconfig_shiftSpline.py, 75 seeded Adam settings, each one run
per pair scored as 16 evaluation variants.

Both stages write their checkpoint after every setting; with ``resume`` a
run that was stopped part-way continues from there, and its arrays, ranks
and winners equal those of a run that was never stopped.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import re
import statistics
import time
from collections import defaultdict
from typing import Iterable, Sequence

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.selfconfig.engine import (
    SweepResult,
    _load_kernels,
    run_stage1_sweep,
    run_stage2_sweep,
)
from convexadam_torch.selfconfig.settings import stage1_settings, stage2_settings

#: the reference's eight sweep pairs (convex_run_withconfig.py:51)
REF_PAIRS = ((2, 4), (4, 9), (3, 4), (0, 4), (1, 4), (4, 7), (4, 5), (2, 8))
#: the reference's own figure for the whole protocol on its GPU, minutes
REFERENCE_MINUTES = 60.0


def make_sweep_fixture(
    H: int = 192, W: int = 160, D: int = 256, L: int = 13,
    n_vols: int = 10, seed: int = 1,
):
    """AbdomenCTCT-like sweep fixture: ``n_vols`` label volumes at the
    reference sweep's shape (192 x 160 x 256) with ``L`` organ-like labels
    (compact blobs of mixed sizes, livers to glands, inside a body region;
    background elsewhere), each subject the same layout rolled by a seeded
    shift of up to 5 voxels an axis.  Returns ``(segs (n_vols, H, W, D)
    int32, L)``, equal to the JAX repository's ``bench.make_sweep_fixture``
    bit for bit."""
    from scipy.ndimage import zoom

    rng = np.random.default_rng(seed)
    ch, cw, cd = H // 4, W // 4, D // 4
    gz, gy, gx = np.meshgrid(
        np.arange(ch), np.arange(cw), np.arange(cd), indexing="ij"
    )
    # organ centres on a jittered grid inside the body, radii mixed; the
    # argmax of (r_l^2 - d2_l) keeps the organs disjoint
    centres = []
    for i in range(L):
        base = np.array(
            [
                ch * (0.3 + 0.4 * ((i * 5) % 7) / 6.0),
                cw * (0.25 + 0.5 * ((i * 3) % 5) / 4.0),
                cd * (0.2 + 0.6 * (i / max(L - 1, 1))),
            ]
        )
        centres.append(base + rng.uniform(-2, 2, 3))
    radii = rng.uniform(3.5, 11.0, L)
    score = np.full((ch, cw, cd), -1.0, np.float64)
    lab = np.zeros((ch, cw, cd), np.int32)
    for i, (c, r) in enumerate(zip(centres, radii), start=1):
        s = r * r - (
            (gz - c[0]) ** 2 + (gy - c[1]) ** 2 + (gx - c[2]) ** 2
        )
        take = s > score
        lab = np.where(take, i, lab)
        score = np.maximum(score, s)
    lab = np.where(score > 0, lab, 0)
    v = zoom(lab, (H / ch, W / cw, D / cd), order=0).astype(np.int32)
    segs = []
    for _ in range(n_vols):
        sh = (int(rng.integers(-5, 6)), int(rng.integers(-5, 6)),
              int(rng.integers(-5, 6)))
        segs.append(np.roll(v, sh, axis=(0, 1, 2)))
    return np.stack(segs), L


@dataclasses.dataclass
class ProtocolResult:
    """Both stages' results and the three records of the protocol (stage 1,
    stage 2, total), the lines the JAX repository's script prints plus the
    measurements named in :func:`run_full_protocol`."""

    stage1: SweepResult
    stage2: SweepResult
    records: "list[dict]"


class _Peaks:
    """The card's peak allocated and reserved GB over one stage (``None``
    on the CPU: not measured).  The allocator's cached blocks are released
    first, so the reserved peak is the stage's own and not what came before
    left in the pool."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def read(self) -> dict:
        if self.dev.type != "cuda":
            return {"peak_allocated_gb": None, "peak_reserved_gb": None}
        return {"peak_allocated_gb": torch.cuda.max_memory_allocated(self.dev) / 1e9,
                "peak_reserved_gb": torch.cuda.max_memory_reserved(self.dev) / 1e9}


def _stage_record(stage, n_settings: int, seconds: float, res: SweepResult, n_pairs: int,
                  peaks: dict) -> dict:
    return {
        "stage": stage,
        "settings": n_settings,
        "minutes": seconds / 60.0,
        "sec_per_setting_pair": float(np.median(res.times)) / n_pairs,
        "rescored": res.rescored,
        "rescore_sec": res.rescore_sec,
        **peaks,
        "resumed_settings": res.resumed,
    }


def run_full_protocol(
    segs: np.ndarray,
    preds: np.ndarray,
    pairs: Sequence[tuple],
    num_labels: int,
    n1: int = 100,
    n2: int = 75,
    checkpoint=None,
    resume: bool = False,
    verbose: bool = False,
    device: "str | torch.device | None" = None,
) -> ProtocolResult:
    """Stage 1 over ``stage1_settings(n1)``, its winner, then stage 2 over
    ``stage2_settings(n2)`` from that winner, on label volumes ``segs``
    (ground truth) and ``preds`` (predictions), both (K, H, W, D) integer,
    for the (fixed, moving) index ``pairs``.

    With ``checkpoint`` (a directory) stage 1 checkpoints to
    ``checkpoint/stage1`` and stage 2 to ``checkpoint/stage2`` after every
    setting; with ``resume`` each stage restores its completed settings (a
    finished stage whole; its winner is recomputed from the restored arrays)
    and runs only the rest.  A checkpoint of another shape is ignored, as in
    the engine, and shows as ``resumed_settings`` 0.  Stage 2 resumes only
    when stage 1 came whole from its checkpoint: a stage-2 checkpoint left
    beside a stage 1 that ran again may belong to another winner.

    The records carry the JAX repository script's keys (stage 1:
    ``settings``, ``minutes``, ``sec_per_setting_pair``, ``best`` (the
    winning setting's repr), ``rescored``; stage 2 the same with
    ``variants`` and ``best_flat_index`` for ``best``; total: ``minutes``,
    ``reference_minutes``, ``speedup``) and, measured: ``rescore_sec``, the
    peak allocated and reserved GB on the card over each stage (the
    allocator's cache emptied as the stage starts), ``resumed_settings``
    (how many settings the checkpoint supplied; their ``times``, and so
    ``sec_per_setting_pair``, come from the run that wrote it, and
    ``rescored`` counts only the settings run in this call) and, in the total,
    ``build_s``, the seconds to build and load the kernels before the
    timed stages.  Runs on ``cuda`` unless ``device="cpu"``."""
    dev = _resolve_device(device)
    pairs = [tuple(p) for p in pairs]
    s1, s2 = stage1_settings(n1), stage2_settings(n2)
    ck1 = ck2 = None
    if checkpoint is not None:
        ck1, ck2 = f"{checkpoint}/stage1", f"{checkpoint}/stage2"
        pathlib.Path(str(checkpoint)).mkdir(parents=True, exist_ok=True)
    tb = time.perf_counter()
    _load_kernels(dev)
    build_s = time.perf_counter() - tb

    t0 = time.perf_counter()
    peaks = _Peaks(dev)
    res1 = run_stage1_sweep(preds, segs, pairs, s1, num_labels=num_labels, verbose=verbose,
                            checkpoint_path=ck1, resume=resume, device=dev)
    t1 = time.perf_counter()
    best1 = s1[res1.best]
    rec1 = _stage_record(1, len(s1), t1 - t0, res1, len(pairs), peaks.read())
    rec1["best"] = repr(best1)
    if verbose:
        print(json.dumps(rec1), flush=True)

    # a stage-2 checkpoint belongs to this stage 1 only when stage 1 came
    # whole from its own; otherwise it may hold another winner's arrays
    resume2 = resume and res1.resumed == len(s1)
    peaks = _Peaks(dev)
    res2 = run_stage2_sweep(preds, segs, pairs, best1, s2, num_labels=num_labels,
                            verbose=verbose, checkpoint_path=ck2, resume=resume2, device=dev)
    t2 = time.perf_counter()
    rec2 = _stage_record(2, len(s2), t2 - t1, res2, len(pairs), peaks.read())
    rec2["variants"] = 16
    rec2["best_flat_index"] = res2.best
    if verbose:
        print(json.dumps(rec2), flush=True)
    minutes = (t2 - t0) / 60.0
    total = {"stage": "total", "minutes": minutes, "reference_minutes": REFERENCE_MINUTES,
             "speedup": REFERENCE_MINUTES / minutes, "build_s": build_s}
    if verbose:
        print(json.dumps(total), flush=True)
    return ProtocolResult(res1, res2, [rec1, rec2, total])


# the engine's verbose lines (engine.py, run_stage1_sweep and run_stage2_sweep)
_STAGE1_LINE = re.compile(
    r"^s=\d+ Stage1Setting\(nn_mult=[\d.]+, grid_sp=(\d+), disp_hw=(\d+)\).* t=([\d.]+)s"
)
_STAGE2_LINE = re.compile(r"^s=\d+ Stage2Setting\(grid_sp_adam=(\d+), avg_n=(\d+).* t=([\d.]+)s")


def summarize_protocol_log(lines: Iterable[str]) -> "list[str]":
    """The per-class table of a protocol log (the verbose lines of
    :func:`run_full_protocol`): for each stage-1 (grid_sp, disp_hw) class
    and each stage-2 (grid_sp_adam, avg_n) class the settings' count and
    the median, largest and total seconds, then the stage records as
    printed.  The counterpart of the JAX repository's
    ``scripts/summarize_protocol_log.py``, with two differences: the two
    stages' classes are kept apart (one (2, 2) class is not the other), and
    the median is over every setting (the port has no compile to drop)."""
    cls: dict = defaultdict(list)
    stages = []
    for line in lines:
        line = line.rstrip("\n")
        for stage, pat in ((1, _STAGE1_LINE), (2, _STAGE2_LINE)):
            m = pat.match(line)
            if m:
                cls[(stage, int(m.group(1)), int(m.group(2)))].append(float(m.group(3)))
                break
        else:
            if line.startswith("{"):
                try:
                    stages.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    out = []
    for stage, a, b in sorted(cls):
        ts = sorted(cls[(stage, a, b)])
        out.append(f"stage {stage} class {(a, b)}: n={len(ts)} median={statistics.median(ts):.4f}s "
                   f"max={ts[-1]:.4f}s total={sum(ts):.4f}s")
    out += [json.dumps(s) for s in stages]
    return out
