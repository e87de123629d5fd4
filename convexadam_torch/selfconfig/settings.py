"""Hyperparameter setting records and the seeded samplers of the sweep.

Counterpart of ``convexadam_tpu/selfconfig/settings.py``.  The reference
couples its two sweep stages through RNG seeds: both scripts re-derive the
same 100 / 75-point search spaces from ``torch.manual_seed(1004 / 2004)`` and
affine transforms of ``torch.rand`` (convex_run_withconfig.py:65-69,
adam_run_withconfig_shiftSpline.py:144-149), and a setting index handed from
stage 1 to stage 2, or kept in a checkpoint, means the same hyperparameters
only under the same seeded stream.  The samplers here draw that stream from
an explicit CPU generator: the same numbers as the global ``torch.rand``
after ``torch.manual_seed``, without touching the global RNG state.  A CUDA
generator would give another stream, so none is used.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Stage1Setting:
    """Stage-1 (convex) setting, semantic features."""

    nn_mult: int
    grid_sp: int
    disp_hw: int


@dataclasses.dataclass(frozen=True)
class Stage1PairedSetting:
    """Stage-1 (convex) setting, paired MIND features."""

    mind_r: int
    mind_d: int
    grid_sp: int
    disp_hw: int


@dataclasses.dataclass(frozen=True)
class Stage2Setting:
    """Stage-2 (Adam) setting.  ``avg_n`` is the raw sampled index; the
    effective smoother-bank index applies the shift-spline rule
    (+2 for grid_sp_adam=1, +1 for grid_sp_adam=2,
    adam_run_withconfig_shiftSpline.py:168-171)."""

    grid_sp_adam: int
    avg_n: int
    lambda_weight: float

    @property
    def effective_avg_n(self) -> int:
        if self.grid_sp_adam == 1:
            return self.avg_n + 2
        if self.grid_sp_adam == 2:
            return self.avg_n + 1
        return self.avg_n


def _torch_rand(seed: int, shape: "tuple[int, int]") -> np.ndarray:
    """``torch.rand(*shape)`` after ``torch.manual_seed(seed)``, drawn from
    a CPU generator of its own."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(*shape, generator=g).numpy()


def stage1_settings(n: int = 100, seed: int = 1004) -> "list[Stage1Setting]":
    """Semantic stage-1 sampler (convex_run_withconfig.py:65-69):
    round(rand*[6,4,6] + [.5,1.5,1.5]); nn_mult x= 2.5;
    disp_hw capped at 5 when grid_sp == 2."""
    r = _torch_rand(seed, (n, 3))
    s = np.round(r * np.array([6, 4, 6]) + np.array([0.5, 1.5, 1.5]))
    s[:, 0] *= 2.5
    cap = s[:, 1] == 2
    s[cap, 2] = np.minimum(s[cap, 2], 5)
    return [
        Stage1Setting(nn_mult=int(a), grid_sp=int(g), disp_hw=int(q))
        for a, g, q in s
    ]


def stage1_paired_settings(n: int = 100, seed: int = 1004) -> "list[Stage1PairedSetting]":
    """Paired-MIND stage-1 sampler (convex_run_paired_mind.py:95-99):
    round(rand*[3,3,4,6] + [.5,.5,1.5,1.5]); disp_hw capped at 5 for grid_sp==2."""
    r = _torch_rand(seed, (n, 4))
    s = np.round(r * np.array([3, 3, 4, 6]) + np.array([0.5, 0.5, 1.5, 1.5]))
    cap = s[:, 2] == 2
    s[cap, 3] = np.minimum(s[cap, 3], 5)
    return [
        Stage1PairedSetting(mind_r=int(a), mind_d=int(b), grid_sp=int(g), disp_hw=int(q))
        for a, b, g, q in s
    ]


def stage2_settings(n: int = 75, seed: int = 2004) -> "list[Stage2Setting]":
    """Stage-2 sampler (adam_run_withconfig_shiftSpline.py:144-149):
    round(rand*[4,5,7] + [.5,.5,1.5]); lambda x= 0.2."""
    r = _torch_rand(seed, (n, 3))
    s = np.round(r * np.array([4, 5, 7]) + np.array([0.5, 0.5, 1.5]))
    s[:, 2] *= 0.2
    return [
        Stage2Setting(grid_sp_adam=int(g), avg_n=int(a), lambda_weight=float(lw))
        for g, a, lw in s
    ]


# evaluation grid of stage 2: snapshots at these iteration counts x extra
# 3^3 box-smoothing passes 0..3 (adam_run_withconfig_shiftSpline.py:234-263)
STAGE2_SNAPSHOT_ITERS: "tuple[int, ...]" = (60, 80, 100, 120)
STAGE2_SMOOTH_LEVELS: int = 4


def decode_adam_variant(adam_s2: int) -> "tuple[int, int]":
    """Decode a flattened stage-2 variant index into (iters, extra smoothing
    passes): ``iters = (s2//4)*20 + 60, kks = s2 % 4``
    (infer_convexadam.py:142-154)."""
    return (adam_s2 // 4) * 20 + 60, adam_s2 % 4
