"""Spacing/direction-aware resampling (SimpleITK ResampleImageFilter
equivalents, pure numpy/scipy).

Reference: ``resample_img`` / ``resample_moving_to_fixed``
(src/convexAdam/convex_adam_utils.py:282-306): linear interpolation, identity
transform, zero default value, output grid defined by (spacing, size, origin,
direction).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import map_coordinates

from convexadam_torch.geometry.image import MedicalImage


def _resample_onto(
    source: MedicalImage,
    out_size_xyz: tuple[int, int, int],
    out_spacing: tuple[float, float, float],
    out_origin: tuple[float, float, float],
    out_direction: tuple[float, ...],
    order: int = 1,
    cval: float = 0.0,
) -> MedicalImage:
    nx, ny, nz = (int(v) for v in out_size_xyz)
    target = MedicalImage(
        np.zeros((nz, ny, nx), np.float32), out_spacing, out_origin, out_direction
    )
    # index grid of the target, in (x, y, z) index coords
    ix, iy, iz = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    idx_xyz = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)
    world = target.index_to_world(idx_xyz)
    src_idx = source.world_to_index(world)  # (N, 3) in (x, y, z) index coords
    # map_coordinates over the (z, y, x) array wants (z_idx, y_idx, x_idx)
    coords = src_idx[:, ::-1].T.reshape(3, nx, ny, nz)
    out = map_coordinates(
        source.data.astype(np.float32), coords, order=order, mode="constant", cval=cval
    )
    # out currently indexed (x, y, z) → store as (z, y, x)
    target.data = np.ascontiguousarray(out.transpose(2, 1, 0))
    return target


def resample_img(
    img: MedicalImage,
    spacing: tuple[float, float, float],
    order: int = 1,
) -> MedicalImage:
    """Resample to a new spacing; size = int(sz*spc/new_spc + 0.5)
    (convex_adam_utils.py:282-292)."""
    size = tuple(
        int(sz * spc / new_spc + 0.5)
        for sz, spc, new_spc in zip(img.size, img.spacing, spacing)
    )
    return _resample_onto(img, size, spacing, img.origin, img.direction, order=order)


def resample_moving_to_fixed(
    fixed: MedicalImage, moving: MedicalImage, order: int = 1
) -> MedicalImage:
    """Resample ``moving`` onto the grid of ``fixed``
    (convex_adam_utils.py:295-306)."""
    return _resample_onto(
        moving, fixed.size, fixed.spacing, fixed.origin, fixed.direction, order=order
    )


def resample_to_reference(
    source: MedicalImage, reference: MedicalImage, order: int = 1
) -> MedicalImage:
    """sitk ``resampler.SetReferenceImage`` equivalent."""
    return _resample_onto(
        source,
        reference.size,
        reference.spacing,
        reference.origin,
        reference.direction,
        order=order,
    )
