"""Learn2Reg 2021 task 1 (abdominal MR/CT): the Adam stage, the thin-plate
spline densification and the field mapped back to the original grid, after
the convex stage of :mod:`reference.convex`.

Written from convexAdam's ``convex_adam_MIND.py:146-191`` (the Adam stage)
and ``l2r_2021_convexAdam_task1_docker.py`` (settings :289-391, ``TPS`` and
``thin_plate_dense`` :198-262, ``convert_crop_field`` :38-105).  Plain
PyTorch and NumPy in float32 (the spline in float64, below), TF32 off for
every matmul and convolution.
Departures from the scripts:

* the spline's system solved and evaluated in float64, the one exact solve
  of the recipe: with no smoothing term and 4096 control points on a
  lattice three voxels apart its condition number is about 4e6, and a
  float32 solve alone moves the densified field by 2.5e-3 to 4.3e-3 voxels
  on average, up to 0.06 (NVIDIA H100, two pairs of the benchmark's
  configuration); the script solved in float32;
* coordinates in array order (axis 0 first), where ``F.affine_grid`` gives
  (x, y, z) = (axis 2, axis 1, axis 0); the spline's distances and affine
  part are the same under that permutation;
* the control points drawn by ``numpy.random.default_rng(seed)``, where the
  script took an unseeded ``torch.randperm``;
* the optimised grid is a plain tensor, where the script held it as the
  weight of a ``Conv3d`` it never applies;
* the moving features of the Adam stage rounded to the convex stage's dtype
  and read in float32 (a bfloat16 control then stands for the recipe's
  card default of bfloat16 features); the script kept them in float32;
* the Adam stage samples by explicit trilinear interpolation at ``index +
  disp * n / (n - 1)``, the script's ``F.grid_sample`` position (the
  align_corners=False identity plus the displacement over ``(n - 1) / 2``)
  without its round trip through normalized coordinates.  The round trip
  puts a point of zero displacement a rounding error before its voxel, and
  the gradient of the interpolation at that kink then comes from the cell
  before it: a different subgradient, which Adam's unit steps carry on.
"""

from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from reference.convex import convex_field, pool, sample
from reference.features import mind_ssc

#: control points the TPS is evaluated against in one block (the script's
#: ``unroll_step_size``)
TPS_BLOCK = 4096


@contextlib.contextmanager
def no_tf32():
    """Full float32 matmuls and convolutions inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _half_scale(shape, device) -> torch.Tensor:
    return torch.tensor([(n - 1) / 2.0 for n in shape], device=device, dtype=torch.float32)


def _box3(x: torch.Tensor) -> torch.Tensor:
    """A zero-padded 3^3 box mean of (C, h, w, d)."""
    return F.avg_pool3d(x[None], 3, stride=1, padding=1)[0]


def trilinear(vol: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``vol`` (C, h, w, d) at voxel positions ``pos`` (3, ...) by trilinear
    interpolation over the eight corners of ``floor(pos)``, corners outside
    the volume read as zeros; differentiable in ``pos``."""
    C = vol.shape[0]
    dims = vol.shape[1:]
    base = torch.floor(pos)
    frac = pos - base
    base = base.long()
    flat = vol.reshape(C, -1)
    out = 0.0
    for corner in itertools.product((0, 1), repeat=3):
        idx = [base[a] + corner[a] for a in range(3)]
        inside = (idx[0] >= 0) & (idx[0] < dims[0]) & (idx[1] >= 0) & (idx[1] < dims[1]) \
            & (idx[2] >= 0) & (idx[2] < dims[2])
        lin = ((idx[0].clamp(0, dims[0] - 1) * dims[1] + idx[1].clamp(0, dims[1] - 1)) * dims[2]
               + idx[2].clamp(0, dims[2] - 1))
        weight = inside.float()
        for a in range(3):
            weight = weight * (frac[a] if corner[a] else 1.0 - frac[a])
        out = out + flat[:, lin.reshape(-1)].reshape((C,) + tuple(pos.shape[1:])) * weight
    return out


def adam_stage(feat_fix: torch.Tensor, feat_mov: torch.Tensor, disp_hr: torch.Tensor, g2: int,
               lambda_weight: float, niter: int) -> torch.Tensor:
    """The Adam stage: features (C, H, W, D) pooled by ``g2`` (the fixed in
    float32, the moving in its own dtype and read in float32), the grid
    initialised by the trilinear resize (align_corners=False) of the
    full-resolution init ``disp_hr`` (3, H, W, D) over ``g2``; each of the
    ``niter`` iterations smooths the grid by three 3^3 box means, adds
    ``lambda_weight`` times the mean squared forward differences along each
    axis, samples the moving features at the identity plus the smoothed
    grid (the script's align_corners=False convention, :func:`trilinear`,
    zeros outside) and adds 12 times
    the mean over channels and voxels of the squared difference, then takes
    a ``torch.optim.Adam`` step (lr 1).  Returns the last iteration's
    smoothed grid times ``g2``, resized trilinearly to (3, H, W, D)."""
    H, W, D = feat_fix.shape[1:]
    small = (H // g2, W // g2, D // g2)
    with torch.no_grad():
        pf = F.avg_pool3d(feat_fix.float()[None], g2, stride=g2)[0]
        pm = F.avg_pool3d(feat_mov.float()[None], g2, stride=g2)[0].to(feat_mov.dtype).float()
        init = F.interpolate(disp_hr[None].float(), size=small, mode="trilinear",
                             align_corners=False)[0] / g2
    index = torch.stack(torch.meshgrid(*[torch.arange(n, device=init.device, dtype=torch.float32)
                                         for n in small], indexing="ij"))
    stretch = torch.tensor([n / (n - 1.0) for n in small], device=init.device).reshape(3, 1, 1, 1)
    w = init.clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=1.0)
    with torch.enable_grad():
        for _ in range(niter):
            opt.zero_grad()
            ds = _box3(_box3(_box3(w)))
            reg = (((ds[:, 1:] - ds[:, :-1]) ** 2).mean()
                   + ((ds[:, :, 1:] - ds[:, :, :-1]) ** 2).mean()
                   + ((ds[:, :, :, 1:] - ds[:, :, :, :-1]) ** 2).mean())
            moved = trilinear(pm, index + ds * stretch)
            cost = ((moved - pf) ** 2).mean(0) * 12.0
            loss = cost.mean() + lambda_weight * reg
            loss.backward()
            opt.step()
    fitted = ds.detach() * g2
    return F.interpolate(fitted[None], size=(H, W, D), mode="trilinear", align_corners=False)[0]


def control_points(fixed_mask: np.ndarray, num_samples: int, seed: int) -> np.ndarray:
    """The TPS's control points (N, 3), normalized, array order: the
    script's (H // 3, W // 3, D // 3) lattice ``linspace(-1, 1, n)`` per
    axis, stretched over the whole extent, kept where ``fixed_mask`` read at
    voxel ``3i + 1`` (cropped to the lattice) is set, and the first
    ``num_samples`` of a permutation drawn from ``seed``."""
    H, W, D = fixed_mask.shape
    n3 = (H // 3, W // 3, D // 3)
    keep = np.asarray(fixed_mask, np.float32)[1::3, 1::3, 1::3][:n3[0], :n3[1], :n3[2]] > 0
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in n3]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)[keep.reshape(-1)]
    return pts[np.random.default_rng(seed).permutation(len(pts))[:num_samples]]


def _tps_u(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``r^2 log(r + 1e-6)`` of the distances between points a (n, 3) and
    b (m, 3), the distance from ``|a|^2 + |b|^2 - 2 a.b`` clamped at 0."""
    r2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None] - 2.0 * a @ b.T
    r = torch.sqrt(r2.clamp(min=0.0))
    return r * r * torch.log(r + 1e-6)


def tps(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """The thin-plate spline through control points ``x1`` (N, 3) with
    values ``y1`` (N, F), no smoothing term, at points ``x2`` (M, 3) → (M,
    F) float32: one direct solve of ``[[U, P], [P^T, 0]] theta = [y1; 0]``,
    ``P`` the rows ``(1, x1)``, then ``U(x2, x1) w + a``, in blocks of
    :data:`TPS_BLOCK` points, all in float64 (module docstring)."""
    x1, y1, x2 = x1.double(), y1.double(), x2.double()
    n = x1.shape[0]
    A = torch.zeros((n + 4, n + 4), dtype=torch.float64, device=x1.device)
    P = torch.cat([torch.ones((n, 1), dtype=torch.float64, device=x1.device), x1], 1)
    A[:n, :n] = _tps_u(x1, x1)
    A[:n, n:] = P
    A[n:, :n] = P.T
    v = torch.zeros((n + 4, y1.shape[1]), dtype=torch.float64, device=x1.device)
    v[:n] = y1
    theta = torch.linalg.solve(A, v)
    w, a = theta[:n], theta[n:]
    out = []
    for j in range(0, x2.shape[0], TPS_BLOCK):
        x = x2[j:j + TPS_BLOCK]
        out.append(_tps_u(x, x1) @ w + a[0] + x[:, 0:1] * a[1] + x[:, 1:2] * a[2]
                   + x[:, 2:3] * a[3])
    return torch.cat(out).float()


def tps_densify(disp: torch.Tensor, fixed_mask: np.ndarray, num_samples: int, step: int,
                smooth: bool, seed: int) -> torch.Tensor:
    """Task 1's densification of a field (3, H, W, D) in voxels: the field
    sampled trilinearly (align_corners=False) at the control points, in
    normalized units; the spline evaluated on the ``step``-strided grid
    (align_corners=True), resized trilinearly (align_corners=True) to
    (H, W, D), back in voxels, and (``smooth``) three 3^3 box means."""
    H, W, D = disp.shape[1:]
    dev = disp.device
    x1 = torch.from_numpy(control_points(fixed_mask, num_samples, seed)).to(dev)
    scale = _half_scale((H, W, D), dev)
    y1 = sample(disp.float(), x1).T / scale
    sub = (H // step, W // step, D // step)
    axes = [torch.linspace(-1.0, 1.0, n, device=dev) for n in sub]
    x2 = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    y2 = tps(x1, y1, x2).T.reshape((3,) + sub)
    dense = F.interpolate(y2[None], size=(H, W, D), mode="trilinear", align_corners=True)[0]
    dense = dense * scale.reshape(3, 1, 1, 1)
    if smooth:
        dense = _box3(_box3(_box3(dense)))
    return dense


def field_to_original(disp: torch.Tensor, spacing_fix, spacing_mov, original: dict) -> torch.Tensor:
    """``convert_crop_field``: a voxel field (3, H, W, D) of the cropped and
    resampled images → the half-resolution voxel field (3, H0 / 2, W0 / 2,
    D0 / 2) over the original fixed grid.  ``original`` holds the fixed and
    moving ``shape``, ``spacing`` and ``crop`` ((lo, hi) voxels), the
    ``ref_spacing`` the crops were resampled to, and the ``flip`` axes
    ("x", "y", "z" for axes 0, 1, 2).  The physical displacement
    ``(x + disp) * spacing_mov - x * spacing_fix`` is sampled (trilinear,
    border, align_corners=True) at each original fixed voxel carried into
    the preprocessed grid, carried on into original moving voxels, less
    the voxel; the flipped axes reversed and negated; then a trilinear x0.5
    resize (align_corners=False)."""
    dev = disp.device
    H, W, D = disp.shape[1:]
    vec = (lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev))
    grid = torch.stack(torch.meshgrid(*[torch.arange(n, device=dev, dtype=torch.float32)
                                        for n in (H, W, D)], indexing="ij"), -1)
    phys = (grid + disp.permute(1, 2, 3, 0)) * vec(spacing_mov) - grid * vec(spacing_fix)
    fix_sp, mov_sp = (np.asarray(original[k], np.float32) for k in ("fix_spacing", "mov_spacing"))
    fix_crop, mov_crop = (np.asarray(original[k], np.float32) for k in ("fix_crop", "mov_crop"))
    ref = np.asarray(original["ref_spacing"], np.float32)
    new_shape = np.round((fix_crop[1] - fix_crop[0]) * fix_sp / ref)
    fix_scale = new_shape / (fix_crop[1] - fix_crop[0])
    mov_scale = new_shape / (mov_crop[1] - mov_crop[0])
    H0, W0, D0 = (int(n) for n in original["fix_shape"])
    orig = torch.stack(torch.meshgrid(*[torch.arange(n, device=dev, dtype=torch.float32)
                                        for n in (H0, W0, D0)], indexing="ij"), -1)
    pre = (orig - vec(fix_crop[0])) * vec(fix_scale)
    pts = (pre / _half_scale((H, W, D), dev) - 1.0).reshape(1, 1, 1, -1, 3).flip(-1)
    at = F.grid_sample(phys.permute(3, 0, 1, 2)[None], pts, mode="bilinear",
                       padding_mode="border", align_corners=True).reshape(3, H0, W0, D0)
    mov_pre = (pre * vec(fix_sp / fix_scale) + at.permute(1, 2, 3, 0)) / vec(mov_sp / mov_scale)
    out = mov_pre / vec(mov_scale) + vec(mov_crop[0]) - orig
    for ax, name in enumerate("xyz"):
        if name in original["flip"]:
            out = torch.flip(out, dims=(ax,))
            out[..., ax] = -out[..., ax]
    return F.interpolate(out.permute(3, 0, 1, 2)[None], size=(H0 // 2, W0 // 2, D0 // 2),
                         mode="trilinear", align_corners=False)[0]


def task1_pair(img_fix: torch.Tensor, img_mov: torch.Tensor, fixed_mask: np.ndarray,
               config: dict, dtype) -> torch.Tensor:
    """The recipe's densified field (3, H, W, D) in voxels of one pair of
    volumes (H, W, D): MIND-SSC, the convex stage with inverse consistency
    in ``dtype``, the Adam stage and the TPS densification, at the settings
    of the configuration's file (``mind_r``, ``mind_d``, ``grid_sp``,
    ``disp_hw``, ``grid_sp_adam``, ``lambda_weight``, ``adam_iters``,
    ``tps_points``, ``tps_step``, ``tps_smooth``, ``tps_seed``)."""
    c = config
    with no_tf32():
        with torch.no_grad():
            ff = mind_ssc(img_fix, c["mind_r"], c["mind_d"], dtype)
            fm = mind_ssc(img_mov, c["mind_r"], c["mind_d"], dtype)
            g = c["grid_sp"]
            field = convex_field(pool(ff, g, dtype), pool(fm, g, dtype), c["disp_hw"], g,
                                 img_fix.shape)
        field = adam_stage(ff, fm, field, c["grid_sp_adam"], c["lambda_weight"], c["adam_iters"])
        del ff, fm
        with torch.no_grad():
            return tps_densify(field, fixed_mask, c["tps_points"], c["tps_step"],
                               c["tps_smooth"], c["tps_seed"])
