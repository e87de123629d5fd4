"""The self-configuring search's seeded setting lists, drawn here again.

The reference derives its search spaces from ``torch.manual_seed(1004)``
and affine maps of ``torch.rand`` (convex_run_withconfig.py:65-69,
convex_run_paired_mind.py:95-99); the same numbers come from a CPU
generator of their own, leaving the global RNG alone.  A setting is a plain
dict, so that the benchmark holds its own copy of the lists and hands the
program only the numbers.
"""

from __future__ import annotations

import numpy as np
import torch


def _rand(seed: int, shape) -> np.ndarray:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(*shape, generator=g).numpy()


def stage1_semantic(n: int, seed: int = 1004) -> "list[dict]":
    """round(rand*[6,4,6] + [.5,1.5,1.5]); nn_mult x= 2.5; disp_hw at most
    5 where grid_sp is 2."""
    s = np.round(_rand(seed, (n, 3)) * np.array([6, 4, 6]) + np.array([0.5, 1.5, 1.5]))
    s[:, 0] *= 2.5
    cap = s[:, 1] == 2
    s[cap, 2] = np.minimum(s[cap, 2], 5)
    return [{"nn_mult": int(a), "grid_sp": int(g), "disp_hw": int(q)} for a, g, q in s]


def stage1_paired(n: int, seed: int = 1004) -> "list[dict]":
    """round(rand*[3,3,4,6] + [.5,.5,1.5,1.5]); disp_hw at most 5 where
    grid_sp is 2."""
    s = np.round(_rand(seed, (n, 4)) * np.array([3, 3, 4, 6]) + np.array([0.5, 0.5, 1.5, 1.5]))
    cap = s[:, 2] == 2
    s[cap, 3] = np.minimum(s[cap, 3], 5)
    return [{"mind_r": int(a), "mind_d": int(b), "grid_sp": int(g), "disp_hw": int(q)}
            for a, b, g, q in s]


SAMPLERS = {"stage1_semantic": stage1_semantic, "stage1_paired": stage1_paired}


def settings_of(traffic: dict) -> "list[dict]":
    """The traffic mix's settings: the first ``settings.first`` of the
    ``settings.of`` that the sampler ``settings.sampler`` draws at
    ``settings.seed``."""
    spec = traffic["settings"]
    drawn = SAMPLERS[spec["sampler"]](int(spec["of"]), int(spec["seed"]))
    return drawn[:int(spec["first"])]
