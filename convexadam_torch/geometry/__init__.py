"""Geometry-aware host-side subsystem: medical image I/O (NIfTI-1 and
MetaImage, pure numpy — no nibabel/SimpleITK dependency), spacing/direction
resampling, and displacement-field space conversions.

Replaces the reference's nibabel/SimpleITK usage
(src/convexAdam/convex_adam_utils.py:282-351, apply_convex.py,
convex_adam_translation.py) with a dependency-free implementation that
follows SimpleITK's conventions: arrays are (z, y, x); spacing/origin/
direction are (x, y, z)-ordered; world frame is LPS.

The port's own copy of ``convexadam_tpu/geometry`` (pure numpy and scipy,
no JAX): files it writes read back in the JAX package and the other way
round.
"""

from convexadam_torch.geometry.image import MedicalImage  # noqa: F401
from convexadam_torch.geometry.io import (  # noqa: F401
    load_volume_nib_order,
    read_image,
    save_volume_nib_order,
    write_image,
)
from convexadam_torch.geometry.resample import (  # noqa: F401
    resample_img,
    resample_moving_to_fixed,
    resample_to_reference,
)
from convexadam_torch.geometry.displacement import (  # noqa: F401
    rescale_displacement_field,
)
