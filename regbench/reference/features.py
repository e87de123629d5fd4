"""The two feature kinds of the stage-1 sweeps: weighted one-hot labels
(convex_run_withconfig.py) and MIND-SSC (convex_adam_utils.py:MINDSSC)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.convex import avg_pool

# the reference's channel order "to have same ordering as C++ code"
MIND_PERMUTATION = (6, 8, 1, 11, 2, 10, 0, 7, 9, 4, 5, 3)


def onehot_pair(pred_fix: torch.Tensor, pred_mov: torch.Tensor, n_channels: int, mult: float,
                dtype) -> "tuple[torch.Tensor, torch.Tensor]":
    """One-hot features (n_channels, H, W, D) of two label volumes, each
    channel weighted by ``1 / (count_fix + count_mov + eps)^0.3``, the
    weights scaled to unit mean over the labels present in either volume,
    then times ``mult``; absent labels weigh 0."""
    labels = torch.arange(n_channels, device=pred_fix.device).reshape(-1, 1, 1, 1)
    oh_f = pred_fix.long()[None] == labels
    oh_m = pred_mov.long()[None] == labels
    counts = (oh_f.sum((1, 2, 3)) + oh_m.sum((1, 2, 3))).float()
    present = counts > 0
    w = torch.where(present, 1.0 / (counts + 1e-32) ** 0.3, torch.zeros_like(counts))
    w = w / (w.sum() / present.sum().clamp(min=1)) * mult
    wv = w.to(dtype).reshape(-1, 1, 1, 1)
    return oh_f.to(dtype) * wv, oh_m.to(dtype) * wv


def _shift(x: torch.Tensor, off) -> torch.Tensor:
    """``x[clamp(i + off)]`` over the three axes of ``x`` (H, W, D)."""
    H, W, D = x.shape
    p = max(abs(o) for o in off)
    xp = F.pad(x[None, None], (p, p, p, p, p, p), mode="replicate")[0, 0]
    return xp[p + off[0]:p + off[0] + H, p + off[1]:p + off[1] + W, p + off[2]:p + off[2] + D]


def _shift_pairs():
    """The 12 pairs of six-neighbourhood offsets at squared distance 2,
    ordered as the reference's mask over (x > y)."""
    six = [(0, 1, 1), (1, 1, 0), (1, 0, 1), (1, 1, 2), (2, 1, 1), (1, 2, 1)]
    out = []
    for x in range(6):
        for y in range(6):
            if x > y and sum((a - b) ** 2 for a, b in zip(six[x], six[y])) == 2:
                out.append((six[x], six[y]))
    return out


def mind_ssc(img: torch.Tensor, radius: int, dilation: int, dtype) -> torch.Tensor:
    """MIND-SSC (12, H, W, D) of a volume (H, W, D): squared differences of
    the 12 shift pairs (replicate border, offsets times ``dilation``), a
    replicate-padded ``2r+1`` box mean, the channel minimum subtracted, the
    channel-mean variance clamped to [0.001, 1000] times its mean,
    ``exp(-mind / var)``, and the reference's channel order."""
    x = img.to(dtype)
    diffs = []
    for s1, s2 in _shift_pairs():
        o1 = [(c - 1) * dilation for c in s1]
        o2 = [(c - 1) * dilation for c in s2]
        d = _shift(x, o1) - _shift(x, o2)
        diffs.append(d * d)
    k = 2 * radius + 1
    ssd = torch.stack(diffs)
    if radius:
        ssd = F.pad(ssd[None], (radius,) * 6, mode="replicate")[0]
    ssd = avg_pool(ssd, k, 1)
    mind = ssd - ssd.min(0, keepdim=True).values
    var = mind.float().mean(0, keepdim=True)
    gm = var.mean()
    var = torch.clamp(var, gm * 0.001, gm * 1000.0).to(dtype)
    mind = torch.exp(-(mind / var))
    return mind[list(MIND_PERMUTATION)]
