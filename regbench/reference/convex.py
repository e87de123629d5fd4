"""The convex stage: pooled features, the SSD cost volume, its box passes,
the coupled convex optimisation and inverse consistency.

Written from convexAdam's ``convex_adam_utils.py`` (``correlate``,
``coupled_convex``, ``inverse_consistency``) in array order: channel 0 of
a field indexes axis 0 (H).  All arithmetic of the stage runs in ``dtype``
(float32 as configured; bfloat16 for the precision control); the field comes
back in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

COUPLING = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0)
IC_ITERS = 15
# bytes of one (3, K^3, chunk) temporary of the coupled argmin
CHUNK_BYTES = 1 << 30


def displacement_mesh(q: int, device, dtype=torch.float32) -> torch.Tensor:
    """Integer displacements (3, K^3) as (dH, dW, dD), flat index
    ``kd*K^2 + kw*K + kh``."""
    r = np.arange(-q, q + 1, dtype=np.float32)
    dd, dw, dh = np.meshgrid(r, r, r, indexing="ij")
    mesh = np.stack([dh.ravel(), dw.ravel(), dd.ravel()])
    return torch.as_tensor(mesh, device=device).to(dtype)


def avg_pool(x: torch.Tensor, k: int, stride: int, padding: int = 0) -> torch.Tensor:
    """``F.avg_pool3d`` of (C, H, W, D), summed in float32 and rounded to
    ``x``'s dtype, as the card's kernel does for bfloat16 (the CPU has none
    for it)."""
    return F.avg_pool3d(x.float()[None], k, stride=stride, padding=padding)[0].to(x.dtype)


def pool(feat: torch.Tensor, g: int, dtype) -> torch.Tensor:
    """The mean over ``g``^3 blocks of features (C, H, W, D) in ``dtype``."""
    return avg_pool(feat.to(dtype), g, g)


def cost_volume(fix: torch.Tensor, mov: torch.Tensor, q: int) -> torch.Tensor:
    """(K^3, h, w, d): at each coarse voxel the channel sum of squared
    differences between the fixed features and the moving ones shifted by
    each displacement, zeros outside the moving volume; in the features'
    dtype, channels added in ascending order."""
    K = 2 * q + 1
    C, h, w, d = fix.shape
    movp = F.pad(mov, (q, q, q, q, q, q))
    out = fix.new_empty((K, K, K, h, w, d))
    for kd in range(K):
        for kw in range(K):
            slabs = torch.stack([movp[:, kh:kh + h, kw:kw + w, kd:kd + d] for kh in range(K)])
            diff = fix[None] - slabs
            acc = diff[:, 0] * diff[:, 0]
            for c in range(1, C):
                acc = acc + diff[:, c] * diff[:, c]
            out[kd, kw] = acc
    return out.reshape(K ** 3, h, w, d)


def smooth_costs(ssd: torch.Tensor) -> torch.Tensor:
    """Two zero-padded 3^3 box means of the cost volume."""
    for _ in range(2):
        ssd = avg_pool(ssd, 3, 1, 1)
    return ssd


def box3(field: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3^3 box mean of a field (3, h, w, d), as window sums
    along H, W, then D, each window added in ascending order."""
    x = field
    for ax in (1, 2, 3):
        n = x.shape[ax]
        xp = F.pad(x, [0, 0] * (3 - ax) + [1, 1])
        x = xp.narrow(ax, 0, n) + xp.narrow(ax, 1, n) + xp.narrow(ax, 2, n)
    return x / 27.0


def coupled_convex(ssd: torch.Tensor, mesh: torch.Tensor) -> torch.Tensor:
    """Six rounds of growing coupling ``c``: per voxel the first
    displacement minimising ``ssd[k] + c * |d_k - s|^2`` against the
    box-smoothed field ``s`` of the round before; the first ``s`` is the
    smoothed plain argmin.  Returns (3, h, w, d) in coarse voxels."""
    shape = ssd.shape[1:]
    flat = ssd.reshape(ssd.shape[0], -1)
    n = flat.shape[1]
    chunk = max(1, CHUNK_BYTES // (3 * ssd.shape[0] * 4))
    soft = box3(mesh[:, torch.argmin(ssd, 0).reshape(-1)].reshape((3,) + tuple(shape)))
    for c in COUPLING:
        s = soft.reshape(3, -1)
        idx = torch.empty(n, dtype=torch.int64, device=ssd.device)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            diff = mesh[:, :, None] - s[:, None, a:b]
            sq = diff * diff
            idx[a:b] = torch.argmin(flat[:, a:b] + c * (sq[0] + sq[1] + sq[2]), 0)
        soft = box3(mesh[:, idx].reshape((3,) + tuple(shape)))
    return soft


def _identity(shape, device, dtype) -> torch.Tensor:
    """``F.affine_grid``'s identity (align_corners=False) in array order,
    (H, W, D, 3)."""
    axes = [(2.0 * torch.arange(n, device=device, dtype=torch.float32) + 1.0) / n - 1.0
            for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).to(dtype)


def sample(vol: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """``F.grid_sample`` (zeros, align_corners=False) of ``vol`` (C, H, W,
    D) at array-order normalized points ``grid`` (..., 3) → (C, ...)."""
    pts = grid.reshape(1, 1, 1, -1, 3).flip(-1)
    out = F.grid_sample(vol[None], pts, mode=mode, padding_mode="zeros", align_corners=False)
    return out.reshape((vol.shape[0],) + tuple(grid.shape[:-1]))


def inverse_consistency(d1: torch.Tensor, d2: torch.Tensor):
    """Jacobi steps ``d1 = (d1 - d2 o (id + d1)) / 2`` and the same for
    ``d2``, fields (3, h, w, d) in normalized units."""
    ident = _identity(d1.shape[1:], d1.device, d1.dtype)
    for _ in range(IC_ITERS):
        s1 = sample(d2, ident + d1.permute(1, 2, 3, 0))
        s2 = sample(d1, ident + d2.permute(1, 2, 3, 0))
        d1, d2 = 0.5 * (d1 - s1), 0.5 * (d2 - s2)
    return d1, d2


def convex_field(fix_s: torch.Tensor, mov_s: torch.Tensor, q: int, g: int,
                 full_shape) -> torch.Tensor:
    """The field (3, H, W, D) in full-resolution voxels, float32, from
    pooled features (C, h, w, d) of one dtype: both directions' cost volume
    and coupled convex, inverse consistency, times ``g`` and a trilinear
    resize (align_corners=False)."""
    mesh = displacement_mesh(q, fix_s.device, fix_s.dtype)
    soft = coupled_convex(smooth_costs(cost_volume(fix_s, mov_s, q)), mesh)
    soft_r = coupled_convex(smooth_costs(cost_volume(mov_s, fix_s, q)), mesh)
    h, w, d = soft.shape[1:]
    scale = torch.tensor([(h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0],
                         device=soft.device).reshape(3, 1, 1, 1).to(soft.dtype)
    ice, _ = inverse_consistency(soft / scale, soft_r / scale)
    lr = (ice * scale * g).float()
    return F.interpolate(lr[None], size=tuple(full_shape), mode="trilinear",
                         align_corners=False)[0]
