"""nnU-Net-style sliding-window helpers (host-side numpy).

A copy of ``convexadam_tpu/utils/sliding_window.py``, which is numpy and
scipy only; the port keeps its own so that it imports nothing of the JAX
package.  Reference: convex_adam_utils.py:196-265, the window steps, the
Gaussian importance map and the nonzero-mask cropping that tile a
segmentation network over a large volume.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_fill_holes, gaussian_filter


def compute_steps_for_sliding_window(
    patch_size, image_size, step_size: float = 0.5
) -> list[list[int]]:
    """Start coordinates per axis so that windows overlap by ``1-step_size``
    (convex_adam_utils.py:196-221)."""
    target_step_sizes_in_voxels = [i * step_size for i in patch_size]
    num_steps = [
        int(np.ceil((i - k) / j)) + 1
        for i, j, k in zip(image_size, target_step_sizes_in_voxels, patch_size)
    ]
    steps = []
    for dim in range(len(patch_size)):
        max_step_value = image_size[dim] - patch_size[dim]
        if num_steps[dim] > 1:
            actual_step_size = max_step_value / (num_steps[dim] - 1)
        else:
            actual_step_size = 99999999999
        steps.append(
            [int(np.round(actual_step_size * i)) for i in range(num_steps[dim])]
        )
    return steps


def get_gaussian(patch_size, sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Gaussian importance map for window blending
    (convex_adam_utils.py:224-237)."""
    tmp = np.zeros(patch_size)
    center_coords = [i // 2 for i in patch_size]
    sigmas = [i * sigma_scale for i in patch_size]
    tmp[tuple(center_coords)] = 1
    g = gaussian_filter(tmp, sigmas, 0, mode="constant", cval=0)
    g = g / np.max(g)
    g = g.astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """Filled union of per-channel nonzero masks (convex_adam_utils.py:240-248)."""
    if data.ndim not in (3, 4):
        raise ValueError("data must be (C, X, Y, Z) or (C, X, Y)")
    nonzero_mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        nonzero_mask = nonzero_mask | (data[c] != 0)
    return binary_fill_holes(nonzero_mask)


def get_bbox_from_mask(mask: np.ndarray, outside_value=0) -> list[list[int]]:
    """Bounding box of non-``outside_value`` voxels (convex_adam_utils.py:251-259)."""
    coords = np.where(mask != outside_value)
    return [[int(np.min(c)), int(np.max(c)) + 1] for c in coords]


def crop_to_bbox(image: np.ndarray, bbox) -> np.ndarray:
    """(convex_adam_utils.py:262-265)"""
    if image.ndim != 3:
        raise ValueError("only supports 3d images")
    return image[tuple(slice(b[0], b[1]) for b in bbox)]
