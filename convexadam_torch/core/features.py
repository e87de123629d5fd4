"""MIND-SSC self-similarity features.

Counterpart of ``mindssc`` in ``convexadam_tpu/core/features.py``.  The 12
shift-pair squared differences, their replicate-padded box mean, the
channel-min subtraction and the channel-mean variance come from the
``mind_ssd_stats`` kernel (:mod:`convexadam_torch.kernels.mind`); the
epilogue here needs the variance's global mean.
"""

from __future__ import annotations

import torch

from convexadam_torch.kernels.mind import _mind_shift_pairs, mind_ssd_stats, shifted_replicate

__all__ = [
    "MIND_CHANNEL_PERMUTATION", "label_counts", "mindssc", "shifted_replicate",
    "_mind_shift_pairs",
]

# the reference's channel order "to have same ordering as C++ code"
MIND_CHANNEL_PERMUTATION = (6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3)


def mindssc(
    img: torch.Tensor, radius: int = 2, dilation: int = 2, dtype=torch.float32
) -> torch.Tensor:
    """MIND-SSC descriptor of ``img`` (H, W, D) → features (12, H, W, D).

    1. 12 shift-pair squared differences (offsets scaled by ``dilation``),
       with the replicate border applied to the difference array;
    2. a ``2*radius+1`` box mean with replicate padding;
    3. per-voxel min subtraction across channels;
    4. the channel-mean variance, clamped to [0.001, 1000] x its global mean;
    5. ``exp(-mind / var)``;
    6. the fixed channel permutation.

    ``dtype`` is the precision of the 12-channel stages; the variance is
    float32 either way.
    """
    x = img.reshape(img.shape[-3:]).to(dtype).contiguous()
    mind, var = mind_ssd_stats(x, radius, dilation)
    var = var[None]
    gm = var.mean()
    var = torch.clamp(var, gm * 0.001, gm * 1000.0)
    mind = torch.exp(-(mind.float() / var)).to(dtype)
    return mind[list(MIND_CHANNEL_PERMUTATION)]


def label_counts(seg: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Per-label voxel counts of the labels ``0 .. num_labels - 1`` (other
    values are not counted) → (num_labels,) int32."""
    flat = seg.reshape(-1).long()
    keep = (flat >= 0) & (flat < num_labels)
    return torch.bincount(flat[keep], minlength=num_labels).to(torch.int32)
