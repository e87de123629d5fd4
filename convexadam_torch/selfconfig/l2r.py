"""Learn2Reg evaluation of one registered case.

Counterpart of ``evaluate_field`` in ``convexadam_tpu/selfconfig/l2r.py``.
The reference delegates its metrics to the external L2R evaluation
repository; like the JAX package, the port computes Dice, Dice30, HD95,
SDlogJ, the negative-Jacobian fraction and keypoint TRE itself.  The task
driver (``L2RTask``, the validation grid, the ranking and the test-set
submission) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from convexadam_torch import _resolve_device
from convexadam_torch.core.edt import MAX_PACKED_EXTENT, hd95_device_sized
from convexadam_torch.core.metrics import (
    dice_coeff,
    hd95,
    jacobian_determinant,
    keypoint_tre,
)
from convexadam_torch.core.warp import warp_with_displacement


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def evaluate_field(
    disp,
    seg_fixed=None,
    seg_moving=None,
    num_labels: int = 0,
    kpts_fixed=None,
    kpts_moving=None,
    spacing: Optional[np.ndarray] = None,
    compute_hd95: bool = True,
    device: "str | torch.device | None" = None,
) -> dict:
    """Official-style metrics of a displacement field (H, W, D, 3) in voxels.

    Inputs are numpy arrays or tensors; the work runs on ``cuda`` unless
    ``device="cpu"``.  Returns ``sdlogj``, ``neg_jac_frac`` and, with labels,
    ``dice`` (per label), ``dice30`` (mean of the worst 30%) and ``hd95``
    (per label), with keypoints ``tre`` (per keypoint) and ``tre30`` (mean of
    the worst 30%); arrays come back as numpy.

    HD95 runs on the device engine (:func:`hd95_device_sized`) whenever every
    axis is at most :data:`MAX_PACKED_EXTENT`.  Beyond it the engine's exact
    FP32 distances do not hold: on the card that raises, before any work;
    with ``device="cpu"`` the host scipy EDT loop scores HD95, as the JAX
    package does off the TPU.  (The JAX package takes the engine only on a
    TPU backend; both give the same numbers.)
    """
    dev = _resolve_device(device)
    beyond = (
        compute_hd95 and seg_fixed is not None and num_labels > 0
        and max(seg_fixed.shape) > MAX_PACKED_EXTENT
    )
    if beyond and dev.type != "cpu":
        raise ValueError(
            f"HD95 on {dev} supports extents <= {MAX_PACKED_EXTENT} per axis "
            f"(got {tuple(seg_fixed.shape)}); pass compute_hd95=False or device='cpu'"
        )
    out: dict = {}
    # the ranges cost nothing without a profiler; they let
    # scripts/profile_torch_evaluation.py split this entry's time by stage
    with record_function("evaluate_field.jacobian"):
        d = _on(disp, dev, torch.float32).permute(3, 0, 1, 2).contiguous()
        det = jacobian_determinant(d)
        logj = torch.log(torch.clamp(det + 3.0, 1e-9, 1e9))
        out["sdlogj"] = float(torch.std(logj.double(), correction=0))
        out["neg_jac_frac"] = float((det < 0).double().mean())
    if seg_fixed is not None and num_labels > 0:
        with record_function("evaluate_field.warp_dice"):
            seg_f = _on(seg_fixed, dev)
            warped = warp_with_displacement(
                _on(seg_moving, dev, torch.float32)[None], d, mode="nearest"
            )[0].round().to(torch.int32)
            dice = dice_coeff(seg_f, warped, num_labels + 1).cpu().numpy()
        out["dice"] = dice
        k = max(1, int((num_labels + 1) * 0.3))
        out["dice30"] = float(np.sort(dice)[:k].mean())
        if compute_hd95:
            with record_function("evaluate_field.hd95"):
                if beyond:
                    out["hd95"] = hd95(seg_f.numpy(), warped.numpy(), num_labels)
                else:
                    out["hd95"] = hd95_device_sized(
                        seg_f, warped, num_labels, device=dev
                    ).cpu().numpy()
    if kpts_fixed is not None:
        with record_function("evaluate_field.tre"):
            tre = keypoint_tre(
                d,
                _on(kpts_fixed, dev, torch.float32),
                _on(kpts_moving, dev, torch.float32),
                None if spacing is None else _on(spacing, dev, torch.float32),
            ).cpu().numpy()
        out["tre"] = tre
        k = max(1, int(len(tre) * 0.3))
        out["tre30"] = float(np.sort(tre)[-k:].mean())
    return out
