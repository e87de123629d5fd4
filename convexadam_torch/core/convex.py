"""Coupled convex optimisation, the global discrete regulariser.

Counterpart of ``coupled_convex`` (exact form) and ``convex_displacement``
in ``convexadam_tpu/core/convex.py``.  Starting from the box-smoothed
argmin field, six rounds with growing coupling ``c`` pick, per coarse
voxel, the displacement minimising ``ssd[k] + c * ||d_k - disp_soft||^2``
and box-smooth the picked field.
"""

from __future__ import annotations

import torch

from convexadam_torch.core.cost_volume import correlate, displacement_mesh
from convexadam_torch.core.smoothing import avg_pool3d

COUPLING_COEFFS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0)

# Dense cost volumes whose estimated footprint (the float32 volume plus one
# smoothing temporary, i.e. twice the raw volume) exceeds this many bytes
# take the streamed path in the JAX package.  The port has the dense path
# only so far and refuses such settings instead.
COST_VOLUME_STREAM_THRESHOLD = 12_000_000_000

# bytes of one (3, K^3, chunk) float32 temporary of the coupled argmin: at
# the sweep's largest dense setting (K^3 = 1331, 983,040 coarse voxels) the
# unchunked difference and its square took 15.7 GB each
COUPLED_CHUNK_BYTES = 1 << 30


def _gather_disp(disp_mesh: torch.Tensor, argmin: torch.Tensor) -> torch.Tensor:
    """disp_mesh (3, K^3) at argmin (h, w, d) → field (3, h, w, d)."""
    return disp_mesh[:, argmin.reshape(-1)].reshape((3,) + tuple(argmin.shape))


def _coupled_argmin(ssd_flat, disp_mesh, s, c, chunk):
    """Per coarse voxel the first displacement minimising
    ``ssd + c * ((sq0 + sq1) + sq2)``, ``chunk`` voxels at a time: the
    (3, K^3, chunk) temporaries stay bounded, and no voxel's arithmetic
    depends on the chunking."""
    n = ssd_flat.shape[1]
    out = torch.empty(n, dtype=torch.int64, device=ssd_flat.device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        diff = disp_mesh[:, :, None] - s[:, None, a:b]  # (3, K^3, chunk)
        sq = diff * diff
        del diff
        coupled = ssd_flat[:, a:b] + c * (sq[0] + sq[1] + sq[2])
        del sq
        out[a:b] = torch.argmin(coupled, dim=0)
    return out


def coupled_convex(
    ssd: torch.Tensor, ssd_argmin: torch.Tensor, disp_mesh: torch.Tensor
) -> torch.Tensor:
    """Solve the coupled convex problem in its exact form.

    ``ssd`` (K^3, h, w, d), ``ssd_argmin`` (h, w, d), ``disp_mesh``
    (3, K^3).  Returns ``disp_soft`` (3, h, w, d) in coarse voxels.  The
    coupled argmin runs over chunks of voxels whose (3, K^3, chunk) float32
    difference takes at most :data:`COUPLED_CHUNK_BYTES`.
    """
    shape = ssd.shape[1:]
    ssd_flat = ssd.reshape(ssd.shape[0], -1)
    chunk = max(1, COUPLED_CHUNK_BYTES // (3 * ssd.shape[0] * 4))
    disp_soft = avg_pool3d(_gather_disp(disp_mesh, ssd_argmin), 3, stride=1, padding=1)
    for c in COUPLING_COEFFS:
        s = disp_soft.reshape(3, -1)
        argmin = _coupled_argmin(ssd_flat, disp_mesh, s, c, chunk).reshape(shape)
        disp_soft = avg_pool3d(_gather_disp(disp_mesh, argmin), 3, stride=1, padding=1)
    return disp_soft


def convex_displacement(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hw: int,
    metric: str = "ssd",
    smooth_passes: int = 2,
    stream_threshold: int = COST_VOLUME_STREAM_THRESHOLD,
) -> torch.Tensor:
    """One convex-stage direction: cost volume + coupled convex.

    Raises ``NotImplementedError`` where the JAX package would switch to its
    streamed path (the dense estimate exceeds ``stream_threshold`` bytes).
    """
    K3 = (2 * disp_hw + 1) ** 3
    n = feat_fix[0].numel()
    if K3 * n * 4 * 2 > stream_threshold:
        raise NotImplementedError(
            f"a dense cost volume of {K3} x {n} float32 exceeds the "
            f"{stream_threshold}-byte threshold; the streamed convex path is not "
            "ported yet (ROADMAP queue A, 'The streamed convex path and the other "
            "cost metrics')"
        )
    ssd, am = correlate(feat_fix, feat_mov, disp_hw, metric=metric, smooth_passes=smooth_passes)
    return coupled_convex(ssd, am, displacement_mesh(disp_hw, device=ssd.device))
