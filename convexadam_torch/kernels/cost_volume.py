"""Dense SSD cost volume: wrapper of ``csrc/cost_volume.cu`` and its plain
version.

Replaces ``convexadam_tpu/ops/cost_volume_pallas.py:cost_volume_pallas``.
Both return the unsmoothed volume (K^3, h, w, d) in float32, flat layout
``k = kd*K^2 + kw*K + kh`` with ``K = 2q + 1``, zeros outside the moving
volume.  The caller applies the box passes and the argmin.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from convexadam_torch.kernels import LAUNCHES, _build


def cost_volume_plain(fix: torch.Tensor, mov: torch.Tensor, disp_hw: int) -> torch.Tensor:
    """Plain PyTorch version: one ``kd`` plane of K^2 shifts at a time, the
    channel sum taken channel by channel in float32 as the kernel does."""
    q = disp_hw
    K = 2 * q + 1
    C, h, w, d = fix.shape
    fix = fix.float()
    movp = F.pad(mov.float(), (q, q, q, q, q, q))
    out = fix.new_empty((K**3, h, w, d))
    for kd in range(K):
        # (K^2, C, h, w, d) with kh fastest: flat index kw*K + kh
        slabs = torch.stack([
            movp[:, kh:kh + h, kw:kw + w, kd:kd + d] for kw in range(K) for kh in range(K)
        ])
        diff = fix[None] - slabs
        acc = diff[:, 0] * diff[:, 0]
        for c in range(1, C):
            acc = acc + diff[:, c] * diff[:, c]
        out[kd * K * K:(kd + 1) * K * K] = acc
    return out


def cost_volume(fix: torch.Tensor, mov: torch.Tensor, disp_hw: int) -> torch.Tensor:
    """(K^3, h, w, d) float32 SSD volume of float32 features (C, h, w, d)."""
    if fix.device.type == "cpu":
        return cost_volume_plain(fix, mov, disp_hw)
    _build.require_cuda(fix, "cost_volume")
    _build.require(fix, "cost_volume fix", (torch.float32,), (None,) * 4)
    _build.require(mov, "cost_volume mov", (torch.float32,), tuple(fix.shape))
    if mov.device != fix.device:
        raise ValueError("cost_volume: fix and mov must lie on one device")
    C, h, w, d = fix.shape
    K = 2 * disp_hw + 1
    out = torch.empty((K**3, h, w, d), dtype=torch.float32, device=fix.device)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind("cost_volume", "cost_volume", [P, P, P, I, I, I, I, I, P])
    err = _build.call_on(
        fix.device, fn, fix.data_ptr(), mov.data_ptr(), out.data_ptr(), C, h, w, d, disp_hw
    )
    _build.check(err, "cost_volume")
    LAUNCHES["cost_volume"] += 1
    return out
