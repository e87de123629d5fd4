"""Evaluation metrics: Dice, HD95 on the host, Jacobian determinant,
keypoint TRE, 3-D SSIM and rank aggregation.

Counterpart of ``convexadam_tpu/core/metrics.py`` (the reference keeps them
in self_configuring/convexAdam_hyper_util.py and its sweep scripts).  The
device HD95 engine is :mod:`convexadam_torch.core.edt`; :func:`hd95` here is
the host loop over scipy EDTs that the evaluator uses beyond the engine's
extent limit.
"""

from __future__ import annotations

import numpy as np
import torch

from convexadam_torch.core.features import label_counts
from convexadam_torch.core.warp import grid_sample_3d


def dice_coeff(outputs: torch.Tensor, labels: torch.Tensor, max_label: int) -> torch.Tensor:
    """Per-label Dice for labels ``1 .. max_label - 1``:
    ``2 mean(o == l and t == l) / (1e-8 + mean(o == l) + mean(t == l))``,
    float32.  The means are exact counts over the voxel count, as the JAX
    package's float32 sums of 0/1 are below 2^24 voxels."""
    o = outputs.reshape(-1)
    t = labels.reshape(-1)
    n = o.numel()
    both = torch.where(o == t, o.long(), -1)
    inter = label_counts(both, max_label)[1:].float() / n
    mi = label_counts(o, max_label)[1:].float() / n
    mt = label_counts(t, max_label)[1:].float() / n
    return 2.0 * inter / (1e-8 + mi + mt)


def edt_distance(mask: np.ndarray) -> np.ndarray:
    """Distance of each nonzero voxel to the nearest zero voxel (scipy)."""
    from scipy.ndimage import distance_transform_edt

    return distance_transform_edt(mask)


def hd95(
    fixed: np.ndarray, moving: np.ndarray, num_labels: int, missing_value: float = 30.0
) -> np.ndarray:
    """Per-label HD95 between host label volumes with the reference's
    semantics (convexAdam_hyper_util.py:32-51): surfaces are voxels at
    interior distance exactly 1; distance maps are interior + exterior EDT
    sums; a label missing from either volume scores ``missing_value``."""
    out = np.zeros(num_labels, np.float64)
    for i in range(1, num_labels + 1):
        f = (fixed == i).astype(np.uint8)
        m = (moving == i).astype(np.uint8)
        if f.sum() > 0 and m.sum() > 0:
            dist1 = edt_distance(f)
            surf1 = dist1 == 1
            dist1 = dist1 + edt_distance(1 - f)
            dist2 = edt_distance(m)
            surf2 = dist2 == 1
            dist2 = dist2 + edt_distance(1 - m)
            out[i - 1] = max(
                np.percentile(dist1[surf2], 95), np.percentile(dist2[surf1], 95)
            )
        else:
            out[i - 1] = missing_value
    return out


def jacobian_determinant(disp: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """Determinant of the Jacobian of ``id + disp`` by central differences
    (the reference's grouped conv3d with kernel [-0.5, 0, 0.5] and zero
    padding), cropped by 2 voxels on every side.

    ``disp`` is (3, H, W, D); with ``normalized`` it is in [-1, 1] units and
    is scaled by ``(n - 1) / 2`` per channel first.
    """
    H, W, D = disp.shape[1:]
    if normalized:
        scale = torch.tensor(
            [(H - 1) / 2.0, (W - 1) / 2.0, (D - 1) / 2.0], dtype=disp.dtype, device=disp.device
        ).reshape(3, 1, 1, 1)
        disp = disp * scale

    def central(x, axis):
        ax = 1 + axis
        n = x.shape[ax]
        zero = torch.zeros_like(x.narrow(ax, 0, 1))
        hi = torch.cat([x.narrow(ax, 1, n - 1), zero], ax)
        lo = torch.cat([zero, x.narrow(ax, 0, n - 1)], ax)
        return (0.5 * hi - 0.5 * lo)[:, 2:-2, 2:-2, 2:-2]

    # J[a][b] = d(disp_a)/d(axis_b) + I
    g = [central(disp, b) for b in range(3)]
    J = [[g[b][a] + (1.0 if a == b else 0.0) for b in range(3)] for a in range(3)]
    return (
        J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1])
        - J[1][0] * (J[0][1] * J[2][2] - J[0][2] * J[2][1])
        + J[2][0] * (J[0][1] * J[1][2] - J[0][2] * J[1][1])
    )


def sd_log_jacobian(
    disp: torch.Tensor, normalized: bool = False, offset: float = 3.0
) -> torch.Tensor:
    """Standard deviation of ``log(det J + offset)``, clamped to [1e-9, 1e9]
    (the sweep scripts' stabilized SDlogJ; ``offset=0`` is the plain L2R
    SDlogJ)."""
    det = jacobian_determinant(disp, normalized=normalized)
    return torch.std(torch.log(torch.clamp(det + offset, 1e-9, 1e9)), correction=0)


def negative_jacobian_fraction(disp: torch.Tensor, normalized: bool = False) -> torch.Tensor:
    """Fraction of voxels with ``det J < 0``."""
    det = jacobian_determinant(disp, normalized=normalized)
    return torch.mean((det < 0).to(torch.float32))


def keypoint_tre(
    disp: torch.Tensor,
    kpts_fixed: torch.Tensor,
    kpts_moving: torch.Tensor,
    spacing=None,
) -> torch.Tensor:
    """Target registration error at keypoints (N, 3), voxel coordinates of
    the fixed image in array order.

    As the reference's sweep scripts: the field (3, H, W, D) is sampled at
    the keypoints normalized with the align_corners=True formula
    ``k / ((n - 1) / 2) - 1`` but interpolated with align_corners=False, and
    ``TRE = |k_fix - k_mov + disp(k_fix)|``, optionally scaled per axis by
    ``spacing``.
    """
    H, W, D = disp.shape[1:]
    scale = torch.tensor(
        [(H - 1) / 2.0, (W - 1) / 2.0, (D - 1) / 2.0], dtype=disp.dtype, device=disp.device
    )
    g = kpts_fixed / scale - 1.0
    sampled = grid_sample_3d(disp, g.reshape(-1, 1, 1, 3), align_corners=False)
    err = kpts_fixed - kpts_moving + sampled.reshape(3, -1).T
    if spacing is not None:
        err = err * spacing
    return torch.sqrt(torch.sum(err * err, dim=1))


# ---------------------------------------------------------------------------
# 3-D SSIM (the reference's test helper, tests/helper_functions.py:100-145)
# ---------------------------------------------------------------------------

def _ssim_gauss_filter(v: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable normalized-Gaussian filter of ``v`` (H, W, D) with zero
    padding: per axis the ``window_size`` shifted slices of the padded
    volume weighted and added in window order (no convolution library, so
    no TF32 on the card)."""
    r = np.arange(window_size, dtype=np.float32) - window_size // 2
    g = np.exp(-(r**2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    half = window_size // 2
    out = v
    for ax in range(3):
        n = out.shape[ax]
        spec = [0, 0] * (2 - ax) + [half, half]
        padded = torch.nn.functional.pad(out, spec)
        acc = None
        for j in range(window_size):
            term = padded.narrow(ax, j, n) * float(g[j])
            acc = term if acc is None else acc + term
        out = acc
    return out


def ssim3d(x: torch.Tensor, y: torch.Tensor, window_size: int = 11,
           sigma: float = 1.5) -> torch.Tensor:
    """Mean 3-D SSIM of volumes (H, W, D) with the reference's Gaussian
    window (sigma 1.5, zero padding), both scaled to [0, 1] by their joint
    minimum and maximum (the reference helper assumes [0, 1] inputs).  A
    0-dim float32 tensor on the inputs' device."""
    x = x.float()
    y = y.float()
    lo = torch.minimum(x.min(), y.min())
    hi = torch.maximum(x.max(), y.max())
    x = (x - lo) / (hi - lo + 1e-12)
    y = (y - lo) / (hi - lo + 1e-12)
    c1, c2 = 0.01**2, 0.03**2

    def f(v):
        return _ssim_gauss_filter(v, window_size, sigma)

    mx, my = f(x), f(y)
    sxx = f(x * x) - mx * mx
    syy = f(y * y) - my * my
    sxy = f(x * y) - mx * my
    ssim_map = ((2 * mx * my + c1) * (2 * sxy + c2)) / (
        (mx * mx + my * my + c1) * (sxx + syy + c2)
    )
    return ssim_map.mean()


def sort_rank(values: np.ndarray) -> np.ndarray:
    """Normalized rank in [0.1, 1]: the smallest value gets 1.0, the
    largest 0.1 (convexAdam_hyper_util.py:28-31), so bigger-is-better
    metrics (Dice) are negated by the caller."""
    values = np.asarray(values, np.float64)
    n = len(values)
    rank = np.empty(n)
    rank[np.argsort(values)] = np.linspace(1.0, 0.1, n)
    return rank


def rank_product(metric_ranks: "list[np.ndarray]") -> np.ndarray:
    """Geometric mean of per-metric normalized ranks
    (convex_run_withconfig.py:162-172)."""
    prod = np.ones_like(metric_ranks[0])
    for r in metric_ranks:
        prod = prod * r
    return prod ** (1.0 / len(metric_ranks))
