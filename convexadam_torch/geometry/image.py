"""MedicalImage — array + physical-space metadata (SimpleITK conventions).

* ``data``: numpy array in (z, y, x) index order (like
  ``sitk.GetArrayFromImage``).
* ``spacing``, ``origin``: (x, y, z)-ordered tuples in mm.
* ``direction``: row-major 3x3 direction-cosine matrix mapping (x, y, z)
  index axes into the world frame (like ``img.GetDirection()``).
"""

from __future__ import annotations

import dataclasses
import numpy as np


@dataclasses.dataclass
class MedicalImage:
    data: np.ndarray  # (z, y, x) or (z, y, x, C)
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0)
    origin: tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: tuple[float, ...] = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)

    def __post_init__(self):
        self.data = np.asarray(self.data)
        self.spacing = tuple(float(s) for s in self.spacing)
        self.origin = tuple(float(o) for o in self.origin)
        self.direction = tuple(float(d) for d in self.direction)
        assert len(self.spacing) == 3 and len(self.origin) == 3
        assert len(self.direction) == 9

    # -- SimpleITK interop (duck-typed: no sitk dependency) ------------------
    @classmethod
    def from_sitk(cls, img) -> "MedicalImage":
        """Build from a SimpleITK image (or anything with the same duck
        type: GetSpacing/GetOrigin/GetDirection plus a module-level
        ``GetArrayFromImage``)."""
        import sys

        mod = sys.modules.get(type(img).__module__)
        if mod is None or not hasattr(mod, "GetArrayFromImage"):
            raise TypeError(
                f"{type(img).__name__} does not look like a SimpleITK image"
            )
        return cls(
            np.asarray(mod.GetArrayFromImage(img)),
            img.GetSpacing(),
            img.GetOrigin(),
            img.GetDirection(),
        )

    def to_sitk(self):
        """Convert to a SimpleITK image (requires the caller's SimpleITK)."""
        import SimpleITK as sitk  # caller dependency, not ours

        out = sitk.GetImageFromArray(self.data)
        out.SetSpacing(self.spacing)
        out.SetOrigin(self.origin)
        out.SetDirection(self.direction)
        return out

    # -- sitk-like accessors -------------------------------------------------
    @property
    def size(self) -> tuple[int, int, int]:
        """(x, y, z) voxel counts (sitk GetSize order)."""
        z, y, x = self.data.shape[:3]
        return (x, y, z)

    @property
    def direction_matrix(self) -> np.ndarray:
        return np.asarray(self.direction, float).reshape(3, 3)

    @property
    def affine(self) -> np.ndarray:
        """4x4 map from (x, y, z) index coords to world mm."""
        A = np.eye(4)
        A[:3, :3] = self.direction_matrix @ np.diag(self.spacing)
        A[:3, 3] = self.origin
        return A

    def index_to_world(self, idx_xyz: np.ndarray) -> np.ndarray:
        """Map (..., 3) (x, y, z) index coords to world mm."""
        idx = np.asarray(idx_xyz, float)
        return idx @ (self.direction_matrix @ np.diag(self.spacing)).T + np.asarray(
            self.origin
        )

    def world_to_index(self, world_xyz: np.ndarray) -> np.ndarray:
        M = self.direction_matrix @ np.diag(self.spacing)
        Minv = np.linalg.inv(M)
        w = np.asarray(world_xyz, float) - np.asarray(self.origin)
        return w @ Minv.T

    def copy_information(self, other: "MedicalImage") -> None:
        """Copy physical-space metadata (sitk CopyInformation)."""
        self.spacing = other.spacing
        self.origin = other.origin
        self.direction = other.direction

    def copy(self) -> "MedicalImage":
        return MedicalImage(
            self.data.copy(), self.spacing, self.origin, self.direction
        )

    def astype(self, dtype) -> "MedicalImage":
        return MedicalImage(
            self.data.astype(dtype), self.spacing, self.origin, self.direction
        )
