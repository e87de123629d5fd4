"""Inputs of the ``abdomenctct-semantic`` configuration: ground-truth and
predicted label volumes of 10 abdominal subjects, made on the device.

The organ layout is a frozen copy of the port's sweep fixture
(``make_sweep_fixture``): 13 compact organs of mixed radii, livers to glands,
placed on a jittered grid by ``numpy.random.default_rng(layout_seed)``, on a
quarter-resolution grid upsampled by nearest neighbours.  Two things differ,
both listed under ``assumed`` in the configuration: each subject is the
layout pulled back by its own smooth field of up to ``warp_max_vox`` voxels
(not a roll, which is a pure translation and wraps organs across the
border), and each prediction is its ground truth pulled back by a finer
field of up to ``noise_max_vox`` voxels (boundary noise, where the roll
fixture predicted the ground truth exactly).

The subjects are one fixed set, drawn from ``subjects_seed``; ``seed``
orders them (which subject stands in each place of the pairs) and draws the
predictions' noise.  So every seed gives the sweep the same organ surfaces
to size its HD95 buffers from, in another order: the seed changes the
answers, not the amount of work.
"""

from __future__ import annotations

import numpy as np
import torch

from rb.synth import scale_to, upsample_field, warp


def organ_layout(shape, n_labels: int, layout_seed: int, device) -> torch.Tensor:
    """The label layout (H, W, D) uint8: organ ``i`` wins where ``r_i^2 -
    |x - c_i|^2`` is largest and positive, on the quarter grid."""
    H, W, D = shape
    rng = np.random.default_rng(layout_seed)
    ch, cw, cd = H // 4, W // 4, D // 4
    centres = []
    for i in range(n_labels):
        base = np.array([ch * (0.3 + 0.4 * ((i * 5) % 7) / 6.0),
                         cw * (0.25 + 0.5 * ((i * 3) % 5) / 4.0),
                         cd * (0.2 + 0.6 * (i / max(n_labels - 1, 1)))])
        centres.append(base + rng.uniform(-2, 2, 3))
    radii = rng.uniform(3.5, 11.0, n_labels)
    gz, gy, gx = torch.meshgrid(*[torch.arange(n, device=device, dtype=torch.float64)
                                  for n in (ch, cw, cd)], indexing="ij")
    score = torch.full((ch, cw, cd), -1.0, dtype=torch.float64, device=device)
    lab = torch.zeros((ch, cw, cd), dtype=torch.uint8, device=device)
    for i, (c, r) in enumerate(zip(centres, radii), start=1):
        s = r * r - ((gz - c[0]) ** 2 + (gy - c[1]) ** 2 + (gx - c[2]) ** 2)
        take = s > score
        lab = torch.where(take, torch.full_like(lab, i), lab)
        score = torch.maximum(score, s)
    lab = torch.where(score > 0, lab, torch.zeros_like(lab))
    up = torch.nn.functional.interpolate(lab[None, None].float(), size=(H, W, D), mode="nearest")
    return up[0, 0].to(torch.uint8)


def make(config: dict, seed: int, device) -> dict:
    """``segs`` and ``preds`` (subjects, H, W, D) int32 host arrays, the
    ``pairs`` and ``num_labels``."""
    shape = tuple(config["shape"])
    n, L = int(config["subjects"]), int(config["labels"])
    layout = organ_layout(shape, L, int(config["layout_seed"]), device)
    gs = torch.Generator(device=device).manual_seed(int(config["subjects_seed"]))
    ctrl_w = torch.randn((n, 3) + tuple(config["warp_ctrl"]), generator=gs, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    order = torch.randperm(n, generator=g, device=device).tolist()
    ctrl_n = torch.randn((n, 3) + tuple(config["noise_ctrl"]), generator=g, device=device)
    segs, preds = [], []
    for i in range(n):
        u = scale_to(upsample_field(ctrl_w[order[i]], shape), float(config["warp_max_vox"]))
        seg = warp(layout, u, "nearest").round().to(torch.uint8)
        v = scale_to(upsample_field(ctrl_n[i], shape), float(config["noise_max_vox"]))
        pred = warp(seg, v, "nearest").round().to(torch.uint8)
        segs.append(seg.cpu())
        preds.append(pred.cpu())
        del u, v, seg, pred
    return {
        "segs": torch.stack(segs).numpy().astype(np.int32),
        "preds": torch.stack(preds).numpy().astype(np.int32),
        "pairs": [tuple(p) for p in config["pairs"]],
        "num_labels": L,
    }
