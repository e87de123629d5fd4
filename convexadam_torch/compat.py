"""Drop-in reference-compatible API surface.

Counterpart of ``convexadam_tpu/compat.py``.  A user of the reference
package can ``from convexadam_torch.compat import convex_adam_pt,
convex_adam`` and keep their call sites: signatures, defaults and return
conventions mirror ``src/convexAdam/convex_adam_MIND.py:64-248``.

Differences, all documented:

* ``device`` is honoured: every entry runs on ``cuda`` unless given
  ``device="cpu"`` (the JAX package accepts it and drops it).
* ``dtype`` accepts ``torch.float16`` / ``torch.float32`` objects or the
  strings ``"float16"/"bfloat16"/"float32"/"auto"``.  float16 maps to
  ``"auto"``, which is bfloat16 on the card and float32 on the CPU: the
  analogue of the reference's fp16-on-GPU / fp32-on-CPU fallback
  (convex_adam_MIND.py:89-91).
* masks may be given as paths (like the reference) or as in-memory volumes.
* ``ic=False`` hands the Adam stage the coarse field upsampled and rescaled
  by ``grid_sp`` in one interpolation, as the JAX package and the
  reference's own challenge scripts do (l2r_2021_convexAdam_task3_docker.py:159),
  not the reference's coarse grid_sp units (convex_adam_MIND.py:144).
* even ``selected_smooth`` values are rounded UP to the next odd kernel:
  the reference warns "selected_smooth should be an odd number" and then
  applies the even box anyway (convex_adam_MIND.py:184-191), which shifts
  the field by half a voxel per pass.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Union

import numpy as np


def _map_dtype(dtype) -> str:
    if dtype is None:
        return "auto"
    s = str(dtype)
    if "bfloat16" in s:  # check FIRST: 'float16' is a substring of
        return "bfloat16"  # 'torch.bfloat16'
    if "float16" in s or s == "auto":
        # fp16 is the reference's GPU fast path; "auto" is bf16 on the card
        return "auto"
    if "float32" in s or "float64" in s:
        return "float32"
    raise ValueError(f"unsupported dtype {dtype!r}")


def _load_mask(mask) -> np.ndarray:
    from convexadam_torch.geometry.io import load_volume_nib_order
    from convexadam_torch.pipeline.convex_adam import validate_volume

    if isinstance(mask, (str, Path)):
        return np.asarray(load_volume_nib_order(mask)[0], np.float32)
    return validate_volume(mask)


def convex_adam_pt(
    img_fixed,
    img_moving,
    mind_r: int = 1,
    mind_d: int = 2,
    lambda_weight: float = 1.25,
    grid_sp: int = 6,
    disp_hw: int = 4,
    selected_niter: int = 80,
    selected_smooth: int = 0,
    grid_sp_adam: int = 2,
    ic: bool = True,
    use_mask: bool = False,
    path_fixed_mask=None,
    path_moving_mask=None,
    dtype=None,
    verbose: bool = False,
    device=None,
) -> np.ndarray:
    """Reference-signature in-memory registration (convex_adam_MIND.py:64-202).

    Returns the displacement field as a float64 (H, W, D, 3) array, exactly
    like the reference (``.astype(float)``, convex_adam_MIND.py:201).
    """
    from convexadam_torch.pipeline.convex_adam import (
        ConvexAdamConfig,
        convex_adam,
        validate_volume,
    )
    from convexadam_torch.pipeline.preprocess import mask_infill

    fixed = validate_volume(img_fixed)
    moving = validate_volume(img_moving)
    if use_mask:
        # EDT nearest-inside infill outside the masks (convex_adam_MIND.py:40-51)
        fixed = mask_infill(fixed, _load_mask(path_fixed_mask), device=device)
        moving = mask_infill(moving, _load_mask(path_moving_mask), device=device)

    t0 = time.time()
    disp = convex_adam(
        fixed,
        moving,
        ConvexAdamConfig(
            mind_r=mind_r,
            mind_d=mind_d,
            lambda_weight=lambda_weight,
            grid_sp=grid_sp,
            disp_hw=disp_hw,
            selected_niter=selected_niter,
            selected_smooth=selected_smooth,
            grid_sp_adam=grid_sp_adam,
            ic=ic,
            dtype=_map_dtype(dtype),
        ),
        device=device,
    )
    if verbose:
        print(f"case time: {time.time() - t0}")
    return disp.astype(float)


def convex_adam(
    path_img_fixed: Union[Path, str],
    path_img_moving: Union[Path, str],
    mind_r: int = 1,
    mind_d: int = 2,
    lambda_weight: float = 1.25,
    grid_sp: int = 6,
    disp_hw: int = 4,
    selected_niter: int = 80,
    selected_smooth: int = 0,
    grid_sp_adam: int = 2,
    ic: bool = True,
    use_mask: bool = False,
    path_fixed_mask=None,
    path_moving_mask=None,
    result_path: Union[Path, str] = "./",
    verbose: bool = False,
    device=None,
) -> None:
    """Reference-signature file-to-file registration: loads the images in
    nibabel order, registers, writes ``<result_path>/disp.nii.gz`` with the
    fixed image's affine (convex_adam_MIND.py:205-248)."""
    from convexadam_torch.geometry.io import load_volume_nib_order, save_volume_nib_order

    fixed, affine = load_volume_nib_order(path_img_fixed)
    moving, _ = load_volume_nib_order(path_img_moving)
    disp = convex_adam_pt(
        np.asarray(fixed, np.float32),
        np.asarray(moving, np.float32),
        mind_r=mind_r,
        mind_d=mind_d,
        lambda_weight=lambda_weight,
        grid_sp=grid_sp,
        disp_hw=disp_hw,
        selected_niter=selected_niter,
        selected_smooth=selected_smooth,
        grid_sp_adam=grid_sp_adam,
        ic=ic,
        use_mask=use_mask,
        path_fixed_mask=path_fixed_mask,
        path_moving_mask=path_moving_mask,
        verbose=verbose,
        device=device,
    )
    os.makedirs(result_path, exist_ok=True)
    # the reference nib.saves the float64 array convex_adam_pt returns
    # (convex_adam_MIND.py:246-248): keep the on-disk dtype identical
    save_volume_nib_order(np.asarray(disp, np.float64), affine, Path(result_path) / "disp.nii.gz")


def apply_convex(disp, moving, device=None) -> np.ndarray:
    """Reference-signature warping (apply_convex.py:13-24): numpy, torch,
    nibabel, SimpleITK or ``MedicalImage`` inputs, like the reference's
    ``validate_image``; trilinear interpolation."""
    from convexadam_torch.pipeline.apply import apply_convex as _apply
    from convexadam_torch.pipeline.convex_adam import validate_volume

    return _apply(validate_volume(disp), validate_volume(moving), device=device)


def convex_adam_translation(
    fixed_image,
    moving_image,
    segmentation=None,
    co_moving_images=None,
    device=None,
):
    """Reference-signature translation alignment
    (convex_adam_translation.py:57-114): SimpleITK images (or
    ``MedicalImage``) in; returns (translation_xyz mm, moved image, moved
    co-moving images), converted back to the input type."""
    from convexadam_torch.geometry.image import MedicalImage
    from convexadam_torch.pipeline.translation import convex_adam_translation as _translate

    was_sitk = not isinstance(fixed_image, MedicalImage)

    def conv(im):
        if im is None or isinstance(im, MedicalImage):
            return im
        return MedicalImage.from_sitk(im)

    co = [conv(c) for c in co_moving_images] if co_moving_images is not None else None
    t, moved, moved_co = _translate(
        conv(fixed_image), conv(moving_image), conv(segmentation), co, device=device
    )
    if was_sitk:
        moved = moved.to_sitk()
        if moved_co is not None:
            moved_co = [c.to_sitk() for c in moved_co]
    return t, moved, moved_co
