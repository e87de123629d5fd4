"""Inputs of the ``nlst-mind`` configuration: exhale/inhale lung CT pairs
with keypoints, made on the device from the seed.

Each pair's fixed (exhale) volume is a CT-like body in Hounsfield units: an
elliptic soft-tissue cylinder (40 HU) in air (-1000), two lungs (-850) as
ellipsoids of seeded size, and in each lung a branching vessel tree of
tubes (40 HU) whose radius shrinks with each generation.  The moving
(inhale) volume is the fixed one pulled back by a smooth breathing field
``w``: ``moving(y) = fixed(y + w(y))``, largest along the cranio-caudal
axis (the last) and growing toward the diaphragm, with a smaller
anterior-posterior part and a seeded smooth part on every axis.  Both
volumes get their own Gaussian noise.  The fixed keypoints lie on vessel
centrelines; each moving keypoint ``y`` solves ``y + w(y) = p`` for its
fixed keypoint ``p`` (fixed-point iterations), so a perfect field reads a
TRE of zero.  The sizes do not depend on the seed, so neither does the
sweep's work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rb.synth import identity, sample_at, scale_to, upsample_field


def _tree_segments(rng_row: np.ndarray, root, direction, length, radius, depth):
    """The segments (a, b, r) of a binary tree grown from ``root``, its
    branch angles and length factors read from ``rng_row`` in order."""
    segs, stack, k = [], [(np.asarray(root, float), np.asarray(direction, float), length, radius,
                           depth)], 0
    while stack:
        a, d, ln, r, dep = stack.pop()
        b = a + d / np.linalg.norm(d) * ln
        segs.append((a, b, r))
        if dep <= 1:
            continue
        for _ in range(2):
            u = rng_row[k:k + 4]
            k += 4
            jitter = (u[:3] - 0.5) * 1.2
            nd = d / np.linalg.norm(d) + jitter
            stack.append((b, nd, ln * (0.7 + 0.15 * u[3]), max(r * 0.75, 1.0), dep - 1))
    return segs


def _segments_per_tree(depth: int) -> int:
    return 2 ** depth - 1


def _anatomy(shape, cfg, u: np.ndarray, device):
    """(volume HU (H, W, D), lung mask, centreline points (M, 3)) of one
    subject, every random choice read from ``u`` in order."""
    H, W, D = shape
    pos = identity(shape, device)
    hu = cfg["hu"]
    body = ((pos[0] - H / 2) / (0.44 * H)) ** 2 + ((pos[1] - W / 2) / (0.42 * W)) ** 2 <= 1.0
    vol = torch.where(body, float(hu["tissue"]), float(hu["air"]))
    lungs = torch.zeros(shape, dtype=torch.bool, device=device)
    vessels = torch.zeros(shape, dtype=torch.bool, device=device)
    depth = int(cfg["tree_depth"])
    k = 6
    points = []
    for side in (-1, 1):
        c = np.array([H / 2 + side * 0.2 * H, W * 0.5, D * 0.55])
        ax = np.array([0.15 * H, 0.3 * W, 0.38 * D]) * (0.9 + 0.2 * u[k:k + 3])
        k += 3
        lung = sum(((pos[a] - c[a]) / ax[a]) ** 2 for a in range(3)) <= 1.0
        lungs |= lung
        n_rand = 4 * 2 * _segments_per_tree(depth)
        root = c + np.array([-side * 0.6 * ax[0], 0.0, 0.3 * ax[2]])
        segs = _tree_segments(u[k:k + n_rand], root, np.array([side * 0.5, 0.1, -1.0]),
                              0.45 * ax[2], float(cfg["root_radius_vox"]), depth)
        k += n_rand
        for a, b, r in segs:
            lo = np.floor(np.minimum(a, b) - r - 1).astype(int).clip(0)
            hi = np.ceil(np.maximum(a, b) + r + 2).astype(int).clip(None, np.array(shape))
            if np.any(hi <= lo):
                continue
            p = pos[:, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
            at = torch.as_tensor(a, dtype=torch.float32, device=device).reshape(3, 1, 1, 1)
            ab = torch.as_tensor(b - a, dtype=torch.float32, device=device).reshape(3, 1, 1, 1)
            t = (((p - at) * ab).sum(0) / float((ab * ab).sum().clamp(min=1e-6))).clamp(0, 1)
            dist2 = ((p - at - t * ab) ** 2).sum(0)
            vessels[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] |= dist2 <= r * r
            n_pts = max(2, int(math.ceil(np.linalg.norm(b - a))))
            ts = np.linspace(0.0, 1.0, n_pts)[:, None]
            points.append(a[None] + ts * (b - a)[None])
        vol = torch.where(lung, float(hu["lung"]), vol)
    vol = torch.where(vessels & lungs, float(hu["vessel"]), vol)
    pts = torch.as_tensor(np.concatenate(points), dtype=torch.float32, device=device)
    idx = [pts[:, a].round().long().clamp(0, shape[a] - 1) for a in range(3)]
    return vol, lungs, pts[lungs[idx[0], idx[1], idx[2]]]


def _breathing(shape, cfg, lung_box, ctrl: torch.Tensor, amp: np.ndarray, device):
    """The field ``w`` (3, H, W, D) in voxels."""
    H, W, D = shape
    pos = identity(shape, device)
    d0, d1 = lung_box
    ramp = ((pos[2] - d0) / max(d1 - d0, 1.0)).clamp(0, 1)
    ramp = ramp * ramp * (3 - 2 * ramp)  # smoothstep: still at the apex, most at the base
    near = torch.exp(-(((pos[0] - H / 2) / (0.45 * H)) ** 2 + ((pos[1] - W / 2) / (0.5 * W)) ** 2))
    w = torch.zeros((3,) + tuple(shape), device=device)
    w[2] = amp[0] * ramp * near
    w[1] = amp[1] * ramp * near
    w = w + scale_to(upsample_field(ctrl, shape), float(cfg["random_max_vox"]))
    return w


def make(config: dict, seed: int, device) -> dict:
    """``imgs_fixed`` and ``imgs_moving`` (pairs, H, W, D) float32 host
    arrays, per pair ``kpts_fixed`` and ``kpts_moving`` (N, 3) float32 host
    arrays in voxels, and the ``spacing``."""
    shape = tuple(config["shape"])
    P, n_kp = int(config["pairs"]), int(config["keypoints"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    depth = int(config["tree_depth"])
    n_u = 6 + 2 * (3 + 4 * 2 * _segments_per_tree(depth)) + 2
    u_all = torch.rand((P, n_u), generator=g, device=device, dtype=torch.float64).cpu().numpy()
    ctrl = torch.randn((P, 3) + tuple(config["random_ctrl"]), generator=g, device=device)
    fixed, moving, kf, km = [], [], [], []
    sigma = float(config["hu"]["noise_sigma"])
    cc = config["breathing_max_vox"]
    for p in range(P):
        u = u_all[p]
        vol, lungs, pts = _anatomy(shape, config, u, device)
        dz = torch.nonzero(lungs.any(0).any(0)).flatten()
        box = (float(dz.min()), float(dz.max()))
        amp = np.array([cc[0] * (0.8 + 0.4 * u[0]), cc[1] * (0.8 + 0.4 * u[1])])
        w = _breathing(shape, config, box, ctrl[p], amp, device)
        # a point pulled from outside the volume sees air, as a scanner would
        air = float(config["hu"]["air"])
        mov = sample_at(vol - air, identity(shape, device) + w, "bilinear") + air
        pick = torch.randperm(len(pts), generator=g, device=device)[:n_kp]
        pf = pts[pick]
        y = pf.clone()
        for _ in range(30):  # y + w(y) = p, w contracts
            wy = torch.stack([sample_at(w[a], y.T, "bilinear") for a in range(3)], 1)
            y = pf - wy
        fixed.append((vol + sigma * torch.randn(shape, generator=g, device=device)).cpu())
        moving.append((mov + sigma * torch.randn(shape, generator=g, device=device)).cpu())
        kf.append(pf.cpu().numpy())
        km.append(y.cpu().numpy())
        del vol, lungs, w, mov
    return {
        "imgs_fixed": torch.stack(fixed).numpy(),
        "imgs_moving": torch.stack(moving).numpy(),
        "kpts_fixed": kf,
        "kpts_moving": km,
        "spacing": np.asarray(config["spacing"], np.float32),
    }
