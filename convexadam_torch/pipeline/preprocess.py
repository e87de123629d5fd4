"""Mask-aware image infill.

Counterpart of ``convexadam_tpu/pipeline/preprocess.py``; reference: the
``use_mask`` branch of ``extract_features``
(src/convexAdam/convex_adam_MIND.py:36-51): dilate the mask with a
replicate-padded 3^3 box filter (> 0.9), find each voxel's nearest
inside-mask voxel at half resolution with a Euclidean distance transform,
gather, upsample trilinearly (x2, align_corners=False), and paste the
original values back inside the mask.  The box filter and the upsampling
run on the entry's device; the EDT runs on the host, as in the reference
and the JAX package, on the same native EDT (:mod:`convexadam_torch.utils.edt`),
so that ties go to the same voxel.
"""

from __future__ import annotations

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.smoothing import avg_pool3d_replicate
from convexadam_torch.core.warp import resize_trilinear
from convexadam_torch.utils.edt import edt_nearest_indices


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def mask_infill(img, mask, device: "str | torch.device | None" = None) -> np.ndarray:
    """Fill the voxels outside ``mask`` with their nearest inside-mask value
    (found at half resolution), keeping the original values inside.

    ``img`` and ``mask`` are (H, W, D) numpy arrays or tensors; returns a
    float32 numpy volume.  Runs on ``cuda`` unless ``device="cpu"``.
    """
    dev = _resolve_device(device)
    img = _host(img)
    H, W, D = img.shape
    mask_t = torch.from_numpy(_host(mask)).to(dev)
    with torch.no_grad():
        mask_d = (avg_pool3d_replicate(mask_t[None], 3)[0] > 0.9).cpu().numpy()

    # half-resolution nearest-inside indices through the EDT of the outside
    idx = edt_nearest_indices(~mask_d[::2, ::2, ::2])
    img_half = img[::2, ::2, ::2]
    h2, w2, d2 = img_half.shape  # ceil(S/2) per axis: the strides below use
    # these (floor(S/2) would gather misaligned voxels on odd axes), and the
    # x2 upsample of an odd axis overshoots by one, cropped back to S
    lin = (idx[0].astype(np.int64) * d2 * w2
           + idx[1].astype(np.int64) * d2
           + idx[2].astype(np.int64))
    gathered = img_half.reshape(-1)[lin.reshape(-1)].reshape(h2, w2, d2)
    with torch.no_grad():
        filled = resize_trilinear(
            torch.from_numpy(np.ascontiguousarray(gathered)).to(dev)[None],
            (2 * h2, 2 * w2, 2 * d2), align_corners=False,
        )[0, :H, :W, :D].cpu().numpy()
    return np.where(mask_d, img, filled).astype(np.float32)
