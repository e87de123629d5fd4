"""Coordinate conventions, grid sampling and warping (differentiable),
trilinear resizing, ``map_coordinates``, inverse consistency, composition
and the Adam data term.

Counterpart of ``convexadam_tpu/core/warp.py``.  Coordinates are kept in
array order: channel 0 indexes axis 0 (H) and channel 2 the innermost axis
(D), never torch ``grid_sample``'s reversed (x, y, z).

The JAX package's corner stack (``build_corner_stack``) exists only because
XLA:TPU gathers are per-index bound; the port's kernels gather the 8
corners straight from the (C, H, W, D) volume instead.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from convexadam_torch.kernels.warp import (
    _grid_corners,
    inverse_consistency_steps,
    sample_trilinear,
    sample_trilinear_bwd,
    warp_ssd_loss_grad,
)


def unnormalize_coord(g, size: int, align_corners: bool):
    """Normalized [-1, 1] coordinate → voxel coordinate (torch's
    ``grid_sampler_unnormalize``)."""
    if align_corners:
        return (g + 1.0) * 0.5 * (size - 1)
    return ((g + 1.0) * size - 1.0) * 0.5


def normalize_coord(x, size: int, align_corners: bool):
    """Inverse of :func:`unnormalize_coord`."""
    if align_corners:
        return x * (2.0 / (size - 1)) - 1.0
    return (2.0 * x + 1.0) / size - 1.0


def identity_grid_voxels(shape: Sequence[int], device=None, dtype=torch.float32) -> torch.Tensor:
    """Identity grid in voxel units, shape (3, H, W, D)."""
    axes = [torch.arange(n, dtype=dtype, device=device) for n in shape]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=0)


def identity_grid_normalized(
    shape: Sequence[int], align_corners: bool, device=None, dtype=torch.float32
) -> torch.Tensor:
    """Identity sampling grid in normalized coordinates, array order,
    shape (H, W, D, 3)."""
    axes = [
        normalize_coord(torch.arange(n, dtype=dtype, device=device), n, align_corners)
        for n in shape
    ]
    gh, gw, gd = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([gh, gw, gd], dim=-1)


def grid_sample_3d(
    vol: torch.Tensor,
    grid: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
    mode: str = "bilinear",
) -> torch.Tensor:
    """Sample ``vol`` (C, H, W, D) at normalized array-order coordinates
    ``grid`` (..., 3) → (C, ...).

    ``F.grid_sample(vol[None], grid_torch[None], mode, padding_mode,
    align_corners)`` with ``grid_torch`` the grid with its last axis
    reversed.  Nearest mode is written out instead, in the JAX package's
    operation order (:func:`unnormalize_coord`, then ``torch.round``, which
    rounds half to even as ``jnp.round`` does): a half-voxel tie that rounds
    the other way would change a warped label.
    """
    C, H, W, D = vol.shape
    out_shape = tuple(grid.shape[:-1])
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    dt = torch.promote_types(vol.dtype, grid.dtype)
    g = grid.reshape(-1, 3).to(dt)
    if mode == "nearest":
        idx, inb = [], None
        for a, n in enumerate((H, W, D)):
            x = unnormalize_coord(g[:, a], n, align_corners)
            if padding_mode == "border":
                x = torch.clamp(x, 0.0, n - 1)
            i = torch.round(x).long()
            ok = (i >= 0) & (i < n)
            inb = ok if inb is None else inb & ok
            idx.append(i.clamp(0, n - 1))
        out = vol.reshape(C, -1).to(dt)[:, (idx[0] * W + idx[1]) * D + idx[2]]
        if padding_mode == "zeros":
            out = torch.where(inb[None, :], out, 0.0)
        return out.reshape((C,) + out_shape)
    if mode != "bilinear":
        raise ValueError(f"unsupported mode: {mode}")
    out = F.grid_sample(
        vol[None].to(dt), g.flip(-1).reshape(1, 1, 1, -1, 3), mode="bilinear",
        padding_mode=padding_mode, align_corners=align_corners,
    )
    return out.reshape((C,) + out_shape)


def _displaced_grid(shape, disp_voxels: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """The reference Adam stage's sampling grid (H, W, D, 3): the identity
    with ``align_corners`` spacing plus the displacement normalized by
    ``(n - 1) / 2`` (an align_corners=True normalization)."""
    H, W, D = shape
    scale = torch.tensor(
        [(H - 1) / 2.0, (W - 1) / 2.0, (D - 1) / 2.0], dtype=disp_voxels.dtype,
        device=disp_voxels.device,
    ).reshape(3, 1, 1, 1)
    grid = identity_grid_normalized(
        (H, W, D), align_corners, device=disp_voxels.device, dtype=disp_voxels.dtype
    )
    return grid + (disp_voxels / scale).permute(1, 2, 3, 0)


def warp_with_displacement(
    vol: torch.Tensor,
    disp_voxels: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
    mode: str = "bilinear",
) -> torch.Tensor:
    """Warp ``vol`` (C, H, W, D) by a voxel displacement field (3, H, W, D).

    The grid is :func:`_displaced_grid`, sampled with ``align_corners``; the
    convention mismatch is the reference's.
    """
    grid = _displaced_grid(vol.shape[1:], disp_voxels, align_corners)
    return grid_sample_3d(
        vol, grid, align_corners=align_corners, padding_mode=padding_mode, mode=mode
    )


class _SampleTrilinear(torch.autograd.Function):
    """:func:`sample_trilinear` (zeros padding, ``align_corners=False``),
    differentiable in the volume and the grid.

    The grid cotangent is one :func:`sample_trilinear_bwd` launch chained
    through the unnormalization (``size / 2`` per axis).  The volume
    cotangent, only when asked for, is a plain scatter-add of ``ct * w`` over
    the 8 corners, as the JAX package computes it outside its kernels.
    """

    @staticmethod
    def forward(ctx, vol, grid):
        ctx.save_for_backward(vol, grid)
        return sample_trilinear(vol, grid)

    @staticmethod
    def backward(ctx, ct):
        vol, grid = ctx.saved_tensors
        B, C, H, W, D = vol.shape
        ct = ct.float().contiguous()
        dvol = dgrid = None
        if ctx.needs_input_grad[1]:
            rows = sample_trilinear_bwd(vol, grid, ct, 1.0)
            half = torch.tensor([H / 2.0, W / 2.0, D / 2.0], device=rows.device)
            dgrid = rows.transpose(1, 2) * half
        if ctx.needs_input_grad[0]:
            dflat = torch.zeros((B, C, H * W * D), dtype=torch.float32, device=vol.device)
            for lin, w in _grid_corners(vol, grid, grads=False):
                for b in range(B):
                    dflat[b].index_add_(1, lin[b], ct[b] * w[b])
            dvol = dflat.reshape(vol.shape).to(vol.dtype)
        return dvol, dgrid


def warp_with_displacement_stacked(vol: torch.Tensor, disp_voxels: torch.Tensor) -> torch.Tensor:
    """Differentiable trilinear warp of ``vol`` (C, H, W, D) float32 or
    bfloat16 by ``disp_voxels`` (3, H, W, D) → (C, H, W, D) float32 (zeros
    padding, ``align_corners=False``, the grid of :func:`_displaced_grid`).

    Counterpart of the JAX package's ``warp_with_displacement_stacked``,
    which takes a prebuilt corner stack and its shape; this one takes the
    volume itself, since the kernels gather its corners directly.  The
    gradient in ``disp_voxels`` launches :func:`sample_trilinear_bwd`.
    """
    C, H, W, D = vol.shape
    grid = _displaced_grid((H, W, D), disp_voxels, False).reshape(1, -1, 3)
    out = _SampleTrilinear.apply(vol.contiguous()[None], grid.contiguous())
    return out.reshape(C, H, W, D)


def _linear_resize_axis(x: torch.Tensor, axis: int, out_size: int, align_corners: bool):
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    i = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners:
        if out_size == 1:
            src = torch.zeros((1,), dtype=torch.float32, device=x.device)
        else:
            src = i * ((in_size - 1) / (out_size - 1))
    else:
        # torch's area_pixel_compute_source_index, clamped below at 0
        src = torch.clamp((i + 0.5) * (in_size / out_size) - 0.5, min=0.0)
    i0 = torch.floor(src).long().clamp(0, in_size - 1)
    i1 = torch.clamp(i0 + 1, max=in_size - 1)
    w1 = (src - i0.to(torch.float32)).to(x.dtype)
    lo = x.index_select(axis, i0)
    hi = x.index_select(axis, i1)
    shape = [1] * x.ndim
    shape[axis] = out_size
    w1 = w1.reshape(shape)
    return lo * (1 - w1) + hi * w1


def resize_trilinear(
    x: torch.Tensor, size: Sequence[int], align_corners: bool = False
) -> torch.Tensor:
    """``F.interpolate(x, size, mode='trilinear', align_corners=ac)`` for
    (..., H, W, D) tensors, one separable pass per axis."""
    nd = x.ndim
    for k, out_size in enumerate(size):
        x = _linear_resize_axis(x, nd - 3 + k, int(out_size), align_corners)
    return x


def map_coordinates_trilinear(
    vol: torch.Tensor, coords: torch.Tensor, mode: str = "constant"
) -> torch.Tensor:
    """``scipy.ndimage.map_coordinates(vol, coords, order=1)`` of ``vol``
    (H, W, D) at voxel coordinates ``coords`` (3, ...) → (...).

    scipy's borders: with ``mode="constant"`` a point outside ``[0, n - 1]``
    on any axis is 0 (no blending with the interior); ``"nearest"`` clamps.
    """
    H, W, D = vol.shape
    out_shape = tuple(coords.shape[1:])
    c = coords.reshape(3, -1)
    if mode == "constant":
        inb = (
            (c[0] >= 0) & (c[0] <= H - 1) & (c[1] >= 0) & (c[1] <= W - 1)
            & (c[2] >= 0) & (c[2] <= D - 1)
        )
    elif mode != "nearest":
        raise ValueError(f"unsupported mode: {mode}")
    axes = []
    for a, n in enumerate((H, W, D)):
        x = torch.clamp(c[a], 0.0, n - 1)
        x0 = torch.floor(x)
        axes.append((x0.long(), x - x0))
    (x0, fx), (y0, fy), (z0, fz) = axes
    flat = vol.reshape(-1)
    acc = torch.zeros((c.shape[1],), dtype=vol.dtype, device=vol.device)
    for dx in (0, 1):
        wx = fx if dx else (1.0 - fx)
        xi = torch.clamp(x0 + dx, max=H - 1)
        for dy in (0, 1):
            wy = fy if dy else (1.0 - fy)
            yi = torch.clamp(y0 + dy, max=W - 1)
            for dz in (0, 1):
                wz = fz if dz else (1.0 - fz)
                zi = torch.clamp(z0 + dz, max=D - 1)
                corner = flat[(xi * W + yi) * D + zi]
                acc = acc + corner * (wx * wy * wz).to(vol.dtype)
    if mode == "constant":
        acc = torch.where(inb, acc, 0.0)
    return acc.reshape(out_shape)


def inverse_consistency(
    disp1: torch.Tensor, disp2: torch.Tensor, iters: int = 20
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Fixed-point symmetrization of forward/backward fields (3, H, W, D) in
    normalized units: each of ``iters`` Jacobi steps sets
    ``d1 = (d1 - d2 ∘ (id + d1)) / 2`` and ``d2 = (d2 - d1 ∘ (id + d2)) / 2``,
    both sampling the other field of the previous step.  On the card all
    steps are one :func:`inverse_consistency_steps` call, one fused launch
    per step."""
    out = inverse_consistency_steps(torch.stack([disp1, disp2]), iters)
    return out[0], out[1]


def compose_displacements(
    disp_1st: torch.Tensor, disp_2nd: torch.Tensor, align_corners: bool = False
) -> torch.Tensor:
    """``disp_2nd + disp_1st ∘ (id + disp_2nd)`` for fields (3, H, W, D) in
    normalized units (the reference's ``combineDeformation3d``)."""
    identity = identity_grid_normalized(
        tuple(disp_2nd.shape[1:]), align_corners, device=disp_2nd.device, dtype=disp_2nd.dtype
    )
    g = identity + disp_2nd.permute(1, 2, 3, 0)
    return disp_2nd + grid_sample_3d(disp_1st, g, align_corners=align_corners)


class _WarpSSDLoss(torch.autograd.Function):
    """The Adam data term with its gradient from the fused kernel.

    The forward launches :func:`warp_ssd_loss_grad` once: the loss and the
    coordinate-gradient rows come out of the same pass.  The loss is linear
    in its cotangent, so the backward only scales the saved rows.
    """

    @staticmethod
    def forward(ctx, disp, mov, fix_flat, cost_scale, stride):
        C, H, W, D = mov.shape
        n = disp[0].numel()  # the sampled points: H*W*D when stride == 1
        fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
        chain = 2.0 * cost_scale / (C * n)
        ssq, rows = warp_ssd_loss_grad(mov, disp.contiguous(), fix_flat, fac, chain, stride)
        ctx.save_for_backward(rows)
        ctx.fac = fac
        ctx.shape = tuple(disp.shape[1:])
        return ssq * (cost_scale / (C * n))

    @staticmethod
    def backward(ctx, grad_out):
        (rows,) = ctx.saved_tensors
        fac = torch.tensor(ctx.fac, dtype=rows.dtype, device=rows.device).reshape(3, 1)
        ddisp = (rows * fac) * grad_out
        return ddisp.reshape(3, *ctx.shape), None, None, None, None


def warp_ssd_mean_loss(
    mov: torch.Tensor, disp: torch.Tensor, fix_flat: torch.Tensor, cost_scale: float,
    stride: int = 1,
) -> torch.Tensor:
    """The Adam data term ``mean(mean_c((warp(mov, disp) - fix)^2) * cost_scale)``.

    ``mov`` (C, H, W, D) float32 or bfloat16, ``disp`` (3, H, W, D) float32 in
    voxels, ``fix_flat`` (C, H*W*D) float32.  Sampling follows the reference's
    deliberate convention mismatch: the identity grid with align_corners=False
    spacing plus the displacement normalized by ``(size - 1) / 2``, sampled
    with align_corners=False, i.e. the position ``index + disp * size /
    (size - 1)`` with zeros outside.  Differentiable in ``disp``.

    With ``stride`` > 1 the mean runs over the ``(::stride,)*3`` sub-lattice
    only: ``disp`` and ``fix_flat`` then carry the sub-lattice's values
    ((3, hs, ws, ds), hs = ceil(H / stride), and (C, hs*ws*ds)), the point
    (i, j, l) samples at ``stride * (i, j, l) + disp * size / (size - 1)``
    of the whole moving volume.
    """
    return _WarpSSDLoss.apply(disp, mov, fix_flat, float(cost_scale), int(stride))


def warp_ssd_mean_loss_unfused(
    mov: torch.Tensor, disp: torch.Tensor, fix_flat: torch.Tensor, cost_scale: float
) -> torch.Tensor:
    """The same data term as :func:`warp_ssd_mean_loss`, composed of the
    differentiable warp :func:`warp_with_displacement_stacked` and plain
    reductions: ``mean(mean_c((warped - fix)^2) * cost_scale)``.  Its
    gradient launches the sampler's forward and backward kernels, one each;
    the positions come through the normalized grid, as the JAX package's
    unfused path composes them.
    """
    C = mov.shape[0]
    warped = warp_with_displacement_stacked(mov, disp).reshape(C, -1)
    cost = ((warped - fix_flat) ** 2).mean(dim=0) * cost_scale
    return cost.mean()
