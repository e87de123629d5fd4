"""Trilinear sampling kernels: wrappers of ``csrc/warp.cu`` and their plain
versions.

* :func:`sample_trilinear` replaces
  ``convexadam_tpu/ops/warp_pallas.py:corner_reduce_fwd``: ``grid_sample``
  (trilinear, zeros padding, ``align_corners=False``) of a batch of float32
  or bfloat16 volumes at normalized coordinates in array order.
* :func:`sample_trilinear_bwd` replaces
  ``convexadam_tpu/ops/warp_pallas.py:corner_reduce_bwd``: the sampler's
  coordinate-gradient rows for a cotangent, the grid half of its
  vector-Jacobian product.
* :func:`warp_ssd_loss_grad` replaces
  ``convexadam_tpu/ops/warp_pallas.py:corner_reduce_loss_grad``: the Adam
  data term's ``sum(res^2)`` and its coordinate-gradient rows in one pass,
  sampling the volume itself (no corner stack).

The plain versions repeat the kernels' arithmetic operation by operation
(corner order dx, dy, dz nested; weights ``((wx*wy)*wz)*mask``; channels in
ascending order), so they agree with the kernels to the bit except for the
order of the ``sum(res^2)`` reduction.
"""

from __future__ import annotations

import ctypes

import torch

from convexadam_torch.kernels import LAUNCHES, _build


def _split(p: torch.Tensor):
    """Integer floor (int64) and fraction of positions ``p``."""
    p0 = torch.floor(p)
    return p0.long(), p - p0


def _corners(axes, H: int, W: int, D: int, grads: bool):
    """The 8 trilinear corners of points given per axis as (floor, frac):
    clamped linear indices and weights with the zeros-padding mask folded
    in, plus (with ``grads``) the three derivative weights."""
    (x0, fx), (y0, fy), (z0, fz) = axes
    wx, wy, wz = (1.0 - fx, fx), (1.0 - fy, fy), (1.0 - fz, fz)
    out = []
    for dx in (0, 1):
        xi = x0 + dx
        vx = (xi >= 0) & (xi < H)
        for dy in (0, 1):
            yi = y0 + dy
            vy = (yi >= 0) & (yi < W)
            for dz in (0, 1):
                zi = z0 + dz
                vz = (zi >= 0) & (zi < D)
                m = (vx & vy & vz).to(fx.dtype)
                lin = (xi.clamp(0, H - 1) * W + yi.clamp(0, W - 1)) * D + zi.clamp(0, D - 1)
                wxy = wx[dx] * wy[dy]
                w = (wxy * wz[dz]) * m
                if not grads:
                    out.append((lin, w))
                    continue
                sx, sy, sz = (1.0 if dx else -1.0), (1.0 if dy else -1.0), (1.0 if dz else -1.0)
                gx = ((wy[dy] * wz[dz]) * sx) * m
                gy = ((wx[dx] * wz[dz]) * sy) * m
                gz = (wxy * sz) * m
                out.append((lin, w, gx, gy, gz))
    return out


def _unnormalize(g: torch.Tensor, size: int) -> torch.Tensor:
    """``grid_sample``'s align_corners=False map from [-1, 1] to voxels."""
    return ((g + 1.0) * size - 1.0) * 0.5


# ---------------------------------------------------------------------------
# sample_trilinear
# ---------------------------------------------------------------------------

def _grid_corners(vol: torch.Tensor, grid: torch.Tensor, grads: bool):
    """:func:`_corners` of the points ``grid`` (B, N, 3) in ``vol`` (B, C, H, W, D)."""
    H, W, D = vol.shape[2:]
    axes = [_split(_unnormalize(grid[..., a], s)) for a, s in enumerate((H, W, D))]
    return _corners(axes, H, W, D, grads)


def _gather(flat: torch.Tensor, lin: torch.Tensor) -> torch.Tensor:
    """Corner values (B, C, N) as float32 of ``flat`` (B, C, H*W*D) at the
    linear indices ``lin`` (B, N)."""
    B, C, _ = flat.shape
    return torch.gather(flat, 2, lin[:, None, :].expand(B, C, lin.shape[1])).float()


def sample_trilinear_plain(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_trilinear`."""
    B, C = vol.shape[:2]
    flat = vol.reshape(B, C, -1)
    acc = None
    for lin, w in _grid_corners(vol, grid, grads=False):
        term = _gather(flat, lin) * w[:, None, :]
        acc = term if acc is None else acc + term
    return acc


def _check_sampler_args(vol, grid, what):
    _build.require_cuda(vol, what)
    _build.require(vol, f"{what} vol", (torch.float32, torch.bfloat16), (None,) * 5)
    _build.require(grid, f"{what} grid", (torch.float32,), (vol.shape[0], None, 3))
    if grid.device != vol.device:
        raise ValueError(f"{what}: vol and grid must lie on one device")


def sample_trilinear(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (B, C, H, W, D) float32 or bfloat16 at normalized
    array-order coordinates ``grid`` (B, N, 3) float32 → (B, C, N) float32."""
    if vol.device.type == "cpu":
        return sample_trilinear_plain(vol, grid)
    _check_sampler_args(vol, grid, "sample_trilinear")
    B, C, H, W, D = vol.shape
    N = grid.shape[1]
    out = torch.empty((B, C, N), dtype=torch.float32, device=vol.device)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind("warp", "sample_trilinear", [P, P, P, I, I, I, I, I, I, I, P])
    with torch.cuda.device(vol.device):
        err = fn(
            vol.data_ptr(), grid.data_ptr(), out.data_ptr(), B, C, H, W, D, N,
            int(vol.dtype == torch.bfloat16), _build.stream(vol.device),
        )
    _build.check(err, "sample_trilinear")
    LAUNCHES["sample_trilinear"] += 1
    return out


# ---------------------------------------------------------------------------
# sample_trilinear_bwd
# ---------------------------------------------------------------------------

def sample_trilinear_bwd_plain(
    vol: torch.Tensor, grid: torch.Tensor, ct: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_trilinear_bwd`."""
    B, C = vol.shape[:2]
    flat = vol.reshape(B, C, -1)
    sx = sy = sz = None
    for lin, _, gx, gy, gz in _grid_corners(vol, grid, grads=True):
        v = _gather(flat, lin)
        tx, ty, tz = v * gx[:, None, :], v * gy[:, None, :], v * gz[:, None, :]
        if sx is None:
            sx, sy, sz = tx, ty, tz
        else:
            sx, sy, sz = sx + tx, sy + ty, sz + tz
    cs = ct * scale
    rows = []
    for s in (sx, sy, sz):
        acc = cs[:, 0] * s[:, 0]
        for c in range(1, C):
            acc = acc + cs[:, c] * s[:, c]
        rows.append(acc)
    return torch.stack(rows, dim=1)


def sample_trilinear_bwd(
    vol: torch.Tensor, grid: torch.Tensor, ct: torch.Tensor, scale: float
) -> torch.Tensor:
    """Coordinate-gradient rows of :func:`sample_trilinear` for the cotangent
    ``ct`` (B, C, N) float32 scaled by ``scale``: (B, 3, N) float32 with
    ``rows[b, a, n] = sum_c ct[b, c, n] * scale * d out[b, c, n] / d p_a``,
    the derivative with respect to the voxel position ``p_a`` on axis ``a``
    (chain it through the unnormalization, ``size / 2``, for the grid)."""
    if vol.device.type == "cpu":
        return sample_trilinear_bwd_plain(vol, grid, ct, scale)
    _check_sampler_args(vol, grid, "sample_trilinear_bwd")
    B, C, H, W, D = vol.shape
    N = grid.shape[1]
    _build.require(ct, "sample_trilinear_bwd ct", (torch.float32,), (B, C, N))
    if ct.device != vol.device:
        raise ValueError("sample_trilinear_bwd: all tensors must lie on one device")
    rows = torch.empty((B, 3, N), dtype=torch.float32, device=vol.device)
    P, I, F = _build.P, _build.I, _build.F  # noqa: E741
    fn = _build.bind(
        "warp", "sample_trilinear_bwd", [P, P, P, P, I, I, I, I, I, I, F, I, P]
    )
    with torch.cuda.device(vol.device):
        err = fn(
            vol.data_ptr(), grid.data_ptr(), ct.data_ptr(), rows.data_ptr(), B, C, H, W, D,
            N, ctypes.c_float(scale), int(vol.dtype == torch.bfloat16),
            _build.stream(vol.device),
        )
    _build.check(err, "sample_trilinear_bwd")
    LAUNCHES["sample_trilinear_bwd"] += 1
    return rows


# ---------------------------------------------------------------------------
# warp_ssd_loss_grad
# ---------------------------------------------------------------------------

def _positions(disp: torch.Tensor, fac) -> "list[torch.Tensor]":
    """Sample positions ``index + disp * fac`` per axis, flattened (N,)."""
    _, H, W, D = disp.shape
    out = []
    for a, n in enumerate((H, W, D)):
        shape = [1, 1, 1]
        shape[a] = n
        idx = torch.arange(n, dtype=torch.float32, device=disp.device).reshape(shape)
        out.append((idx + disp[a] * fac[a]).reshape(-1))
    return out


def warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain):
    """Plain PyTorch version of :func:`warp_ssd_loss_grad`."""
    C, H, W, D = mov.shape
    axes = [_split(p) for p in _positions(disp, fac)]
    flat = mov.float().reshape(C, H * W * D)
    s = sx = sy = sz = None
    for lin, w, gx, gy, gz in _corners(axes, H, W, D, grads=True):
        v = flat[:, lin]
        if s is None:
            s, sx, sy, sz = v * w, v * gx, v * gy, v * gz
        else:
            s, sx, sy, sz = s + v * w, sx + v * gx, sy + v * gy, sz + v * gz
    res = s - fix_flat
    ssq = (res * res).sum()
    ct = res * chain
    rows = []
    for g in (sx, sy, sz):
        acc = ct[0] * g[0]
        for c in range(1, C):
            acc = acc + ct[c] * g[c]
        rows.append(acc)
    return ssq, torch.stack(rows)


def warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain: float):
    """Adam data term of the moving features ``mov`` (C, H, W, D) float32 or
    bfloat16, sampled at ``index + disp * fac`` (disp (3, H, W, D) float32,
    ``fac`` three floats), against ``fix_flat`` (C, H*W*D) float32.

    Returns ``(ssq, rows)``: the 0-dim float32 ``sum(res^2)`` and the (3, N)
    float32 gradient rows of ``sum(res^2) * chain / 2`` with respect to the
    sample positions.
    """
    if mov.device.type == "cpu":
        return warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain)
    _build.require_cuda(mov, "warp_ssd_loss_grad")
    _build.require(mov, "warp_ssd_loss_grad mov", (torch.float32, torch.bfloat16), (None,) * 4)
    C, H, W, D = mov.shape
    N = H * W * D
    _build.require(disp, "warp_ssd_loss_grad disp", (torch.float32,), (3, H, W, D))
    _build.require(fix_flat, "warp_ssd_loss_grad fix", (torch.float32,), (C, N))
    if disp.device != mov.device or fix_flat.device != mov.device:
        raise ValueError("warp_ssd_loss_grad: all tensors must lie on one device")
    P, I, F = _build.P, _build.I, _build.F  # noqa: E741
    n_parts = _build.bind("warp", "warp_ssd_num_partials", [I])(N)
    rows = torch.empty((3, N), dtype=torch.float32, device=mov.device)
    partials = torch.empty((n_parts,), dtype=torch.float32, device=mov.device)
    total = torch.empty((1,), dtype=torch.float32, device=mov.device)
    fn = _build.bind(
        "warp", "warp_ssd_loss_grad", [P, P, P, P, P, P, I, I, I, I, F, F, F, F, I, P]
    )
    with torch.cuda.device(mov.device):
        err = fn(
            mov.data_ptr(), disp.data_ptr(), fix_flat.data_ptr(), rows.data_ptr(),
            partials.data_ptr(), total.data_ptr(), C, H, W, D,
            ctypes.c_float(fac[0]), ctypes.c_float(fac[1]), ctypes.c_float(fac[2]),
            ctypes.c_float(chain), int(mov.dtype == torch.bfloat16), _build.stream(mov.device),
        )
    _build.check(err, "warp_ssd_loss_grad")
    LAUNCHES["warp_ssd_loss_grad"] += 1
    return total[0], rows
