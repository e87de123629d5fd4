"""Dense SSD cost volume: wrapper of ``csrc/cost_volume.cu`` and its plain
version.

Replaces ``convexadam_tpu/ops/cost_volume_pallas.py:cost_volume_pallas``.
Both return the unsmoothed volume (K^3, h, w, d) in float32, flat layout
``k = kd*K^2 + kw*K + kh`` with ``K = 2q + 1``, zeros outside the moving
volume.  The caller applies the box passes and the argmin.

On the card, the half-widths the self-configuring search draws, q = 1..7,
run a kernel compiled for that q (:func:`kernel_for`); any other q runs a
general kernel with q at run time.  The entry is bound once.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from convexadam_torch.kernels import LAUNCHES, _build

# csrc/cost_volume.cu compiles cost_volume_kernel<Q> for these Q: the
# disp_hw range of the self-configuring sweep
COMPILED_Q = range(1, 8)


def kernel_for(disp_hw: int) -> str:
    """The ``__global__`` function that computes a volume of half-width
    ``disp_hw`` on the card: the one compiled for it, or the general one."""
    return "cost_volume_kernel" if disp_hw in COMPILED_Q else "cost_volume_general_kernel"


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


@functools.lru_cache(maxsize=None)
def _entry():
    P, I = _build.P, _build.I  # noqa: E741
    return _build.bind("cost_volume", "cost_volume", (P, P, P, I, I, I, I, I, I, P))


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
    err = _build.call_on(
        fix.device, _entry(), fix.data_ptr(), mov.data_ptr(), out.data_ptr(), C, h, w, d,
        disp_hw, int(kernel_for(disp_hw) == "cost_volume_general_kernel"),
    )
    _build.check(err, "cost_volume")
    LAUNCHES["cost_volume"] += 1
    return out
