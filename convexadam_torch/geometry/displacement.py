"""Displacement-field space conversions.

Reference: ``rescale_displacement_field`` (convex_adam_utils.py:309-351) —
take a field computed on a resampled fixed grid, resample it onto the
original moving image's grid, rotate the vectors by the fixed→moving
direction mismatch, and rescale by the spacing ratio.  Field channels are
(z, y, x)-ordered voxel displacements (the sitk-array convention).
"""

from __future__ import annotations

import numpy as np

from convexadam_torch.geometry.image import MedicalImage
from convexadam_torch.geometry.resample import resample_to_reference


def rescale_displacement_field(
    displacement_field: np.ndarray,
    moving_image: MedicalImage,
    fixed_image: MedicalImage,
    fixed_image_resampled: MedicalImage,
) -> np.ndarray:
    """Rescale a (z, y, x, 3) field from ``fixed_image_resampled``'s grid into
    ``moving_image``'s grid/spacing (channels stay (dz, dy, dx) voxels)."""
    channels = []
    for i in range(3):
        ch = MedicalImage(
            np.ascontiguousarray(displacement_field[:, :, :, i]).astype(np.float32),
            fixed_image_resampled.spacing,
            fixed_image_resampled.origin,
            fixed_image_resampled.direction,
        )
        channels.append(resample_to_reference(ch, moving_image).data)
    field = np.stack(channels, axis=-1)

    fixed_dir = fixed_image.direction_matrix
    moving_dir = moving_image.direction_matrix
    rotation = np.linalg.inv(fixed_dir) @ moving_dir

    # rotate vectors: channels are (z, y, x) → flip to (x, y, z), rotate, flip
    field = field[..., ::-1]
    field = field @ rotation
    field = field[..., ::-1]

    scaling = np.array(fixed_image_resampled.spacing) / np.array(moving_image.spacing)
    return field * scaling[::-1]
