"""Dense discretised cost volume ("correlation layer").

Counterpart of ``correlate``, ``correlate_masked`` and ``displacement_mesh``
in ``convexadam_tpu/core/cost_volume.py``.  For a displacement half-width
``q`` the volume holds, at every coarse voxel, the channel-summed SSD (or,
with ``metric="sad"``, the summed absolute difference, the OASIS task-3
script's cost) between the fixed features and the moving features shifted
by each of the ``(2q+1)**3`` integer displacements (zeros outside), flat
index ``k = kd*K**2 + kw*K + kh``.  It is made by the ``cost_volume`` kernel
in float32 whatever the features' dtype, then smoothed by zero-padded 3^3
box passes with the reference's rounding (:func:`window_mean3d`: one-hot
semantic features give exactly tied costs, and the argmin takes the first
minimum).
"""

from __future__ import annotations

import numpy as np
import torch

from convexadam_torch.core.smoothing import window_mean3d
from convexadam_torch.kernels.cost_volume import cost_volume


def displacement_mesh(disp_hw: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Integer displacement mesh (3, K**3) in voxels, channels in array
    order (dH, dW, dD), flat index ``kd*K**2 + kw*K + kh``."""
    q = disp_hw
    r = np.arange(-q, q + 1, dtype=np.float32)
    dd, dw, dh = np.meshgrid(r, r, r, indexing="ij")
    mesh = np.stack([dh.ravel(), dw.ravel(), dd.ravel()], axis=0)
    return torch.as_tensor(mesh, dtype=dtype, device=device)


def correlate(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hw: int,
    metric: str = "ssd",
    smooth_passes: int = 2,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Dense cost volume of coarse features (C, h, w, d).

    ``metric`` is ``"ssd"`` or ``"sad"``; ``smooth_passes`` the number of
    3^3 box passes (2 in the packaged pipeline, 1 in the lung and OASIS
    recipes).  Returns the box-smoothed volume (K**3, h, w, d) float32 and
    its argmin over the displacement axis (h, w, d) int64.
    """
    ssd = cost_volume(feat_fix.float().contiguous(), feat_mov.float().contiguous(), disp_hw,
                      metric)
    for _ in range(smooth_passes):
        ssd = window_mean3d(ssd, 3, stride=1, padding=1)
    return ssd, torch.argmin(ssd, dim=0)


def correlate_masked(
    feat_fix: torch.Tensor, feat_mov: torch.Tensor, mask: torch.Tensor, disp_hw: int
) -> "tuple[torch.Tensor, torch.Tensor]":
    """The SSD cost volume gated by a coarse-grid mask (h, w, d) (``ssd *=
    mask``, then the argmin), as the CuRIOUS MRI-US pipeline uses it: a
    voxel outside the mask costs 0 for every displacement, so its argmin is
    the first candidate and the coupling sets its field."""
    ssd, _ = correlate(feat_fix, feat_mov, disp_hw)
    ssd = ssd * mask.to(ssd.dtype)[None]
    return ssd, torch.argmin(ssd, dim=0)
