"""Helpers of the fixture generators: smooth random fields and warps, made
on the device from one generator."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample_field(ctrl: torch.Tensor, shape) -> torch.Tensor:
    """Control values (3, h, w, d) to a smooth field (3, H, W, D) by a
    trilinear resize with aligned corners."""
    return F.interpolate(ctrl[None], size=tuple(shape), mode="trilinear", align_corners=True)[0]


def scale_to(field: torch.Tensor, amplitude: float) -> torch.Tensor:
    """``field`` scaled so that its largest component reads ``amplitude``."""
    return field * (amplitude / field.abs().max().clamp(min=1e-12))


def sample_at(vol: torch.Tensor, pos: torch.Tensor, mode: str) -> torch.Tensor:
    """``vol`` (H, W, D) at voxel positions ``pos`` (3, ...) in array order
    (``mode`` "nearest" or "bilinear"; zeros outside)."""
    H, W, D = vol.shape
    norm = torch.stack([2.0 * pos[a] / (n - 1) - 1.0 for a, n in enumerate((H, W, D))], -1)
    grid = norm.reshape(1, 1, 1, -1, 3).flip(-1)
    out = F.grid_sample(vol[None, None].float(), grid, mode=mode, padding_mode="zeros",
                        align_corners=True)
    return out.reshape(pos.shape[1:])


def identity(shape, device) -> torch.Tensor:
    """Voxel positions (3, H, W, D)."""
    axes = [torch.arange(n, device=device, dtype=torch.float32) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"))


def warp(vol: torch.Tensor, field: torch.Tensor, mode: str) -> torch.Tensor:
    """``vol`` pulled back by a voxel field (3, H, W, D):
    ``out(x) = vol(x + field(x))``."""
    return sample_at(vol, identity(vol.shape, vol.device) + field, mode)
