"""Euclidean distance transform with nearest-site indices, on the host.

Semantics of ``scipy.ndimage.distance_transform_edt(input,
return_indices=True)`` as the reference's mask infill uses it
(convex_adam_MIND.py:44,49): for every nonzero voxel of ``input``, the index
of (and distance to) the nearest zero voxel; zero voxels map to themselves.
Counterpart of ``convexadam_tpu/utils/edt.py``, always on the native C++
EDT (:mod:`convexadam_torch.native`): where several zero voxels are nearest,
it picks the one the JAX package's native EDT picks, which scipy does not.
"""

from __future__ import annotations

import numpy as np

from convexadam_torch.native import edt3d


def edt_nearest_indices(input_mask: np.ndarray) -> np.ndarray:
    """(3, H, W, D) int32 indices of the nearest zero voxel of each voxel."""
    return edt3d(input_mask, with_distance=False)[0]


def edt_distance(input_mask: np.ndarray, sampling=None) -> np.ndarray:
    """(H, W, D) float32 distance of each voxel to the nearest zero voxel.
    With ``sampling`` (the voxel spacing, one value or one per axis),
    scipy's ``distance_transform_edt(input_mask, sampling=sampling)``, in
    float64, as the JAX package computes it."""
    if sampling is None:
        return edt3d(input_mask, with_distance=True)[1]
    from scipy.ndimage import distance_transform_edt

    return distance_transform_edt(input_mask, sampling=sampling)
