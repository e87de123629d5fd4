"""Registration features: MIND-SSC self-similarity, nnU-Net semantic
one-hot, and the nnU-Net intensity normalisers.

Counterpart of ``convexadam_tpu/core/features.py``.  The 12 MIND shift-pair
squared differences, their replicate-padded box mean, the channel-min
subtraction and the channel-mean variance come from the ``mind_ssd_stats``
kernel (:mod:`convexadam_torch.kernels.mind`); the epilogue here needs the
variance's global mean.
"""

from __future__ import annotations

import numpy as np
import torch

from convexadam_torch.kernels.mind import _mind_shift_pairs, mind_ssd_stats, shifted_replicate

__all__ = [
    "MIND_CHANNEL_PERMUTATION", "label_counts", "mind_epilogue", "mindssc",
    "mindssc_multichannel", "nnunet_ct_norm", "nnunet_norm", "nnunet_norm_props",
    "semantic_features", "semantic_template_weights", "shifted_replicate", "_mind_shift_pairs",
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
    return mind_epilogue(mind, var, var[None].mean(), dtype)


def mind_epilogue(mind: torch.Tensor, var: torch.Tensor, gm: torch.Tensor, dtype) -> torch.Tensor:
    """Steps 4-6 of :func:`mindssc` on ``mind_ssd_stats``' (mind, var) with
    the variance's global mean ``gm`` given: a slab of a volume split along
    H (:mod:`convexadam_torch.parallel.spatial`) takes ``gm`` of the whole
    volume's variance."""
    var = torch.clamp(var[None], gm * 0.001, gm * 1000.0)
    mind = torch.exp(-(mind.float() / var)).to(dtype)
    return mind[list(MIND_CHANNEL_PERMUTATION)]


def mindssc_multichannel(imgs, radius: int = 2, dilation: int = 2) -> torch.Tensor:
    """MIND-SSC of several aligned volumes, concatenated along the channels
    (the CuRIOUS front-end's 24 channels of T1 and FLAIR)."""
    return torch.cat([mindssc(img, radius, dilation) for img in imgs], dim=0)


def label_counts(seg: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Per-label voxel counts of the labels ``0 .. num_labels - 1`` (other
    values are not counted) → (num_labels,) int32."""
    flat = seg.reshape(-1).long()
    keep = (flat >= 0) & (flat < num_labels)
    return torch.bincount(flat[keep], minlength=num_labels).to(torch.int32)


def _inverse_frequency(counts: torch.Tensor) -> torch.Tensor:
    """``1 / (count + eps)^0.3`` for labels present in either volume, 0 for
    the rest, normalized to unit mean over the present labels."""
    present = counts > 0
    w = torch.where(present, 1.0 / torch.pow(counts + 1e-32, 0.3), 0.0)
    return w / (w.sum() / torch.clamp(present.sum(), min=1))


def semantic_features(
    pred_fixed: torch.Tensor,
    pred_moving: torch.Tensor,
    num_labels: int,
    mult: float = 10.0,
    dtype=torch.float32,
    weights: "torch.Tensor | None" = None,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """nnU-Net one-hot features (num_labels, H, W, D) of two integer label
    volumes (H, W, D), weighted by inverse label frequency.

    ``weight_l = 1 / (count_fix(l) + count_mov(l) + eps)^0.3``, normalized
    to unit mean over the labels present in either volume, times ``mult``;
    labels absent from both get weight 0.  ``weights`` (num_labels,)
    replaces the per-pair derivation (before ``mult``).  Labels outside
    ``[0, num_labels)`` give all-zero rows, as ``jax.nn.one_hot`` does.  The
    weights are cast to ``dtype`` before the multiply, as the JAX package
    casts them.
    """
    pf = pred_fixed.to(torch.int32)
    pm = pred_moving.to(torch.int32)
    if weights is None:
        counts = label_counts(pf, num_labels) + label_counts(pm, num_labels)
        w = _inverse_frequency(counts.float()) * mult
    else:
        w = weights.float() * mult
    labels = torch.arange(num_labels, dtype=torch.int32, device=pf.device).reshape(-1, 1, 1, 1)
    wv = w.to(dtype).reshape(num_labels, 1, 1, 1)
    return (pf[None] == labels).to(dtype) * wv, (pm[None] == labels).to(dtype) * wv


def semantic_template_weights(
    seg_a: torch.Tensor, seg_b: torch.Tensor, num_labels: int
) -> torch.Tensor:
    """Per-label weights of one template pair, frozen for a whole test set
    (the OASIS task-3 script): ``1 / (count_a + count_b)^0.3`` normalized to
    unit mean; a label absent from both volumes gets 0 and is left out of
    the mean."""
    counts = label_counts(seg_a, num_labels) + label_counts(seg_b, num_labels)
    return _inverse_frequency(counts.float())


# ---------------------------------------------------------------------------
# intensity normalisers (the reference's convex_adam_utils.py)
# ---------------------------------------------------------------------------

def nnunet_norm(img: torch.Tensor) -> torch.Tensor:
    """Z-score over the positive-intensity mask, zeros elsewhere."""
    mask = img > 0
    n = torch.clamp(mask.sum(), min=1)
    mean = torch.where(mask, img, 0.0).sum() / n
    var = torch.where(mask, (img - mean) ** 2, 0.0).sum() / torch.clamp(n - 1, min=1)
    out = (img - mean) / (torch.sqrt(var) + 1e-8)
    return torch.where(mask, out, 0.0)


def nnunet_norm_props(img: torch.Tensor, props: dict) -> torch.Tensor:
    """Clamp to stored percentiles, then z-score with stored statistics."""
    img1 = torch.clamp(img, props["percentile_00_5"], props["percentile_99_5"])
    return (img1 - props["mean"]) / props["sd"]


def _quantile_linear(sorted_flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear interpolation) of the sorted values of
    ``x``, with the position arithmetic in float32 as JAX does it; unlike
    ``torch.quantile`` it takes any number of elements."""
    pos = np.float32(q) * (np.float32(sorted_flat.numel()) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    return sorted_flat[int(low)] * float(np.float32(1) - hw) + sorted_flat[int(high)] * float(hw)


def nnunet_ct_norm(img: torch.Tensor) -> torch.Tensor:
    """CT normalisation: clamp to [-1000, 1500], then to the 0.5 / 99.5
    percentiles, and z-score with the mean and the unbiased standard
    deviation of the first clamp."""
    img = torch.clamp(img, -1000.0, 1500.0)
    mean = img.mean()
    std = img.std(correction=1)
    flat = torch.sort(img.reshape(-1)).values
    img = torch.clamp(img, _quantile_linear(flat, 0.005), _quantile_linear(flat, 0.995))
    return (img - mean) / std
