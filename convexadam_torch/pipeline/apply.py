"""Warp application: apply a displacement field to a moving image.

Counterpart of ``convexadam_tpu/pipeline/apply.py``; reference:
apply_convex.py.  ``apply_convex`` warps with scipy's ``map_coordinates``
(order 1, constant zero outside) at ``identity + disp``;
``apply_convex_original_moving`` first rescales the field into the original
moving image's space (no moving-image resample) and then warps.  The JAX
package computes the warp outside any Pallas kernel, and so does the port:
the plain gather of :func:`map_coordinates_trilinear`, on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.warp import identity_grid_voxels, map_coordinates_trilinear
from convexadam_torch.geometry.displacement import rescale_displacement_field
from convexadam_torch.geometry.image import MedicalImage


def apply_convex_torch(disp: torch.Tensor, moving: torch.Tensor) -> torch.Tensor:
    """Warp ``moving`` (H, W, D) by ``disp`` (H, W, D, 3) (voxels, channels
    in array order), on their device (apply_convex.py:13-24)."""
    coords = identity_grid_voxels(moving.shape, moving.device) + disp.permute(3, 0, 1, 2)
    return map_coordinates_trilinear(moving, coords, mode="constant")


def _volume(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, MedicalImage):
        x = x.data
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    return t.to(dev, torch.float32)


def apply_convex(disp, moving, device: "str | torch.device | None" = None) -> np.ndarray:
    """numpy arrays, tensors or ``MedicalImage`` in, float32 numpy out.
    Runs on ``cuda`` unless ``device="cpu"``."""
    dev = _resolve_device(device)
    with torch.no_grad():
        return apply_convex_torch(_volume(disp, dev), _volume(moving, dev)).cpu().numpy()


def apply_convex_original_moving(
    disp: np.ndarray,
    moving_image_original: MedicalImage,
    fixed_image_original: MedicalImage,
    fixed_image_resampled: MedicalImage,
    device: "str | torch.device | None" = None,
) -> MedicalImage:
    """Warp the *original* moving image (no resampling of the moving image):
    rescale the field into the moving image's space first
    (apply_convex.py:27-78)."""
    field = rescale_displacement_field(
        np.asarray(disp, np.float32),
        moving_image=moving_image_original,
        fixed_image=fixed_image_original,
        fixed_image_resampled=fixed_image_resampled,
    )
    warped = apply_convex(field, moving_image_original.data, device=device)
    return MedicalImage(
        warped.astype(np.float32),
        moving_image_original.spacing,
        moving_image_original.origin,
        moving_image_original.direction,
    )
