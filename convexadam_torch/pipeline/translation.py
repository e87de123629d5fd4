"""Translation-only registration: run the full ConvexAdam at 1 mm
isotropic, reduce the field to a whole-voxel translation, and shift the
moving image's *origin* (no resampling).

Counterpart of ``convexadam_tpu/pipeline/translation.py``; reference:
convex_adam_translation.py:12-145.  The resampling runs on the host
(scipy), the registration on the entry's device.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from convexadam_torch.geometry.image import MedicalImage
from convexadam_torch.geometry.resample import resample_img, resample_moving_to_fixed
from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam


def index_translation_to_world_translation(
    index_translation: Iterable[float], direction: Iterable[float]
) -> np.ndarray:
    """(i, j, k) mm along the image grid → (x, y, z) world mm
    (convex_adam_translation.py:12-28)."""
    direction = list(direction)
    dim = int(np.sqrt(len(direction)))
    direction_matrix = np.array(direction).reshape(dim, dim)
    return direction_matrix @ np.array(list(index_translation), float)


def apply_translation(
    moving_image: MedicalImage, translation_ijk: Iterable[float] = (0, 0, 0)
) -> MedicalImage:
    """Shift the image origin by a grid-aligned translation in mm
    (convex_adam_translation.py:31-54)."""
    moving_image = moving_image.copy()
    translation_xyz = index_translation_to_world_translation(
        translation_ijk, moving_image.direction
    )
    origin = np.array(moving_image.origin) - translation_xyz
    moving_image.origin = tuple(origin)
    return moving_image


def convex_adam_translation(
    fixed_image: MedicalImage,
    moving_image: MedicalImage,
    segmentation: Optional[MedicalImage] = None,
    co_moving_images: Optional[list] = None,
    cfg: Optional[ConvexAdamConfig] = None,
    device: "str | torch.device | None" = None,
):
    """Estimate and apply a whole-voxel translation
    (convex_adam_translation.py:57-114); the registration runs on ``cuda``
    unless ``device="cpu"``.

    Returns (translation_xyz mm, moved image, moved co-moving images).
    """
    fixed_image_resampled = resample_img(fixed_image, spacing=(1.0, 1.0, 1.0))
    moving_image_resampled = resample_moving_to_fixed(fixed_image_resampled, moving_image)

    displacementfield = convex_adam(
        fixed_image_resampled.data.astype(np.float32),
        moving_image_resampled.data.astype(np.float32),
        cfg or ConvexAdamConfig(),
        device=device,
    )  # (z, y, x, 3) voxel units at 1 mm iso, channels (dz, dy, dx)

    if segmentation is not None:
        seg = resample_moving_to_fixed(fixed_image_resampled, segmentation)
        mask = seg.data > 0
        translation_zyx = displacementfield[mask].mean(axis=0)
    else:
        translation_zyx = displacementfield.mean(axis=(0, 1, 2))

    spacing_zyx = np.array(list(moving_image.spacing)[::-1])
    translation_ijk = translation_zyx / spacing_zyx
    translation_ijk_voxels = np.round(translation_ijk, decimals=0)
    translation_ijk_mm = translation_ijk_voxels * spacing_zyx
    translation_xyz = tuple(translation_ijk_mm[::-1])

    moving_image = apply_translation(moving_image, translation_ijk=translation_xyz)

    if co_moving_images is not None:
        co_moving_images = [
            apply_translation(img, translation_ijk=translation_xyz)
            for img in co_moving_images
        ]
    return translation_xyz, moving_image, co_moving_images
