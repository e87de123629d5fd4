"""The sweeps' scores of one field and the rank aggregation.

Dice and the Jacobian statistics follow convex_run_withconfig.py:138-152,
HD95 follows convexAdam_hyper_util.py's EDT definition, computed here by
brute force over surface points; TRE follows convex_run_paired_mind.py;
the ranks follow convexAdam_hyper_util.py:28-31 and
convex_run_withconfig.py:162-172.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from reference.convex import _identity, sample

HD95_MISSING = 30.0


def warp_labels(seg: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour warp of a label volume (H, W, D) by a voxel field
    (3, H, W, D): sampled at the identity (align_corners=False) plus the
    field over ``(n - 1) / 2``, zeros outside."""
    H, W, D = seg.shape
    scale = torch.tensor([(H - 1) / 2.0, (W - 1) / 2.0, (D - 1) / 2.0],
                         device=disp.device).reshape(3, 1, 1, 1)
    grid = _identity((H, W, D), disp.device, torch.float32) + (disp / scale).permute(1, 2, 3, 0)
    return sample(seg.float()[None], grid, mode="nearest")[0].round().long()


def dice(seg_a: torch.Tensor, seg_b: torch.Tensor, num_labels: int) -> np.ndarray:
    """Per-label Dice (num_labels,) of labels 1..num_labels, float64."""
    a, b = seg_a.reshape(-1).long(), seg_b.reshape(-1).long()
    n = num_labels + 1
    ca = torch.bincount(a.clamp(0, n), minlength=n + 1)[1:n].double()
    cb = torch.bincount(b.clamp(0, n), minlength=n + 1)[1:n].double()
    both = torch.where(a == b, a, torch.zeros_like(a)).clamp(0, n)
    ci = torch.bincount(both, minlength=n + 1)[1:n].double()
    N = a.numel()
    return (2.0 * (ci / N) / (1e-8 + ca / N + cb / N)).cpu().numpy()


def jacobian_stats(disp: torch.Tensor) -> "tuple[float, float]":
    """(SDlogJ, negative fraction) of ``id + disp``: central differences
    ``[-0.5, 0, 0.5]`` with zero padding, cropped by 2 voxels a side;
    SDlogJ is the population standard deviation of
    ``log(clamp(det + 3, 1e-9, 1e9))``; float64."""
    d = disp.double()

    def grad(axis):
        x = F.pad(d, [0, 0] * (2 - axis) + [1, 1])
        n = d.shape[axis + 1]
        g = 0.5 * x.narrow(axis + 1, 2, n) - 0.5 * x.narrow(axis + 1, 0, n)
        return g[:, 2:-2, 2:-2, 2:-2]

    g = [grad(b) for b in range(3)]
    J = [[g[b][a] + (1.0 if a == b else 0.0) for b in range(3)] for a in range(3)]
    det = (J[0][0] * (J[1][1] * J[2][2] - J[1][2] * J[2][1])
           - J[1][0] * (J[0][1] * J[2][2] - J[0][2] * J[2][1])
           + J[2][0] * (J[0][1] * J[1][2] - J[0][2] * J[1][1]))
    logd = torch.log(torch.clamp(det + 3.0, 1e-9, 1e9))
    return float(logd.std(correction=0)), float((det < 0).double().mean())


def _faces(mask: torch.Tensor, pad_value: bool) -> "list[torch.Tensor]":
    """The six face neighbours of every voxel of ``mask``, voxels beyond
    the volume read as ``pad_value``."""
    p = F.pad(mask[None, None].float(), (1, 1, 1, 1, 1, 1), value=float(pad_value))[0, 0] > 0.5
    H, W, D = mask.shape
    out = []
    for a in range(3):
        for o in (0, 2):
            sl = [slice(1, 1 + H), slice(1, 1 + W), slice(1, 1 + D)]
            sl[a] = slice(o, o + mask.shape[a])
            out.append(p[tuple(sl)])
    return out


def _surface(mask: torch.Tensor) -> torch.Tensor:
    """Voxels of ``mask`` at interior distance exactly 1: a face neighbour
    inside the volume lies outside the mask."""
    nb = _faces(mask, True)
    any_out = ~nb[0]
    for x in nb[1:]:
        any_out |= ~x
    return mask & any_out


def _shell(mask: torch.Tensor) -> torch.Tensor:
    """Voxels outside ``mask`` with a face neighbour in it."""
    nb = _faces(mask, False)
    any_in = nb[0].clone()
    for x in nb[1:]:
        any_in |= x
    return ~mask & any_in


def _nearest_sq(query: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Squared distance (int64) from each query point (n, 3) to the nearest
    target point (m, 3), exactly, by brute force in blocks."""
    out = torch.empty(query.shape[0], dtype=torch.int64, device=query.device)
    step = max(1, (1 << 26) // max(1, target.shape[0]))
    t = target.int()
    for a in range(0, query.shape[0], step):
        d = query[a:a + step, None, :].int() - t[None]
        out[a:a + step] = (d * d).sum(-1).min(1).values
    return out


def _dist_at(mask: torch.Tensor, pts: torch.Tensor, inside: torch.Tensor) -> np.ndarray:
    """The reference's distance map of ``mask`` (interior plus exterior
    EDT) at points ``pts``: to the nearest voxel outside the mask for points
    inside it, to the nearest mask voxel for the others."""
    sq = torch.empty(pts.shape[0], dtype=torch.int64, device=pts.device)
    if inside.any():
        sq[inside] = _nearest_sq(pts[inside], torch.nonzero(_shell(mask)))
    if (~inside).any():
        sq[~inside] = _nearest_sq(pts[~inside], torch.nonzero(_surface(mask)))
    return np.sqrt(sq.cpu().numpy().astype(np.float64))


def hd95(seg_fix: torch.Tensor, seg_warped: torch.Tensor, num_labels: int) -> np.ndarray:
    """Per-label HD95 (num_labels,) float64: the larger of the 95th
    percentiles of each volume's distance map over the other's surface; a
    label missing from either volume scores :data:`HD95_MISSING`."""
    out = np.full(num_labels, HD95_MISSING)
    for lab in range(1, num_labels + 1):
        f, m = seg_fix == lab, seg_warped == lab
        if not (f.any() and m.any()):
            continue
        sf, sm = torch.nonzero(_surface(f)), torch.nonzero(_surface(m))
        d1 = _dist_at(f, sm, f[tuple(sm.T)])
        d2 = _dist_at(m, sf, m[tuple(sf.T)])
        out[lab - 1] = max(np.percentile(d1, 95), np.percentile(d2, 95))
    return out


def keypoint_tre(disp: torch.Tensor, kf: torch.Tensor, km: torch.Tensor, spacing) -> np.ndarray:
    """TRE (N,) float64 at the fixed keypoints (N, 3): the field sampled
    (trilinear, align_corners=False) at ``k / ((n - 1) / 2) - 1``, and
    ``|(k_fix - k_mov + disp(k_fix)) * spacing|``."""
    H, W, D = disp.shape[1:]
    scale = torch.tensor([(H - 1) / 2.0, (W - 1) / 2.0, (D - 1) / 2.0], device=disp.device)
    s = sample(disp.float(), kf / scale - 1.0)  # (3, N)
    err = (kf - km + s.T).double() * torch.as_tensor(spacing, device=disp.device).double()
    return torch.sqrt((err * err).sum(1)).cpu().numpy()


def robust30_keypoints(kf: np.ndarray, km: np.ndarray) -> np.ndarray:
    """The 30% keypoints of largest initial error."""
    tre0 = np.sqrt(((kf - km) ** 2).sum(-1))
    return np.argsort(-tre0)[:max(int(len(tre0) * 0.3), 1)]


def sort_rank(values) -> np.ndarray:
    """Rank in [0.1, 1]: the smallest value 1.0, the largest 0.1."""
    values = np.asarray(values, np.float64)
    rank = np.empty(len(values))
    rank[np.argsort(values)] = np.linspace(1.0, 0.1, len(values))
    return rank


def rank_product(ranks) -> np.ndarray:
    """Geometric mean of the per-metric ranks."""
    prod = np.ones_like(ranks[0])
    for r in ranks:
        prod = prod * r
    return prod ** (1.0 / len(ranks))
