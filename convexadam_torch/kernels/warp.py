"""Trilinear sampling kernels: wrappers of ``csrc/warp.cu`` and their plain
versions.

* :func:`sample_trilinear` replaces
  ``convexadam_tpu/ops/warp_pallas.py:corner_reduce_fwd``: ``grid_sample``
  (trilinear, zeros padding, ``align_corners=False``) of a batch of float32
  or bfloat16 volumes at normalized coordinates in array order.
* :func:`inverse_consistency_steps` replaces the same Pallas kernel in its
  inverse-consistency role: the Jacobi steps of two fields, one fused
  launch per step, all issued by one C call.
* :func:`sample_trilinear_bwd` replaces
  ``convexadam_tpu/ops/warp_pallas.py:corner_reduce_bwd``: the sampler's
  coordinate-gradient rows for a cotangent, the grid half of its
  vector-Jacobian product.
* :func:`warp_ssd_loss_grad` replaces
  ``convexadam_tpu/ops/warp_pallas.py:corner_reduce_loss_grad``: the Adam
  data term's ``sum(res^2)`` and its coordinate-gradient rows in one pass,
  sampling the volume itself (no corner stack), on the whole Adam grid or
  on its ``(::stride,)*3`` sub-lattice, or on the rows of either from
  ``row0`` (a slab of a grid split along H).

The plain versions repeat the kernels' arithmetic operation by operation
(corner order dx, dy, dz nested; weights ``((wx*wy)*wz)*mask``; channels in
ascending order), so they agree with the kernels to the bit except for the
order of the ``sum(res^2)`` reduction.

The wrappers sit on short host paths (the inverse-consistency steps sample
2 x 3 x 32^3 points, far less work than issuing a launch, and the Adam loop
calls the data term 80 times a registration): their entries' argument types
are fixed once, and ctypes converts the float arguments itself.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from convexadam_torch.kernels import LAUNCHES, _build

P, I, F = _build.P, _build.I, _build.F  # noqa: E741
_SAMPLE_ARGS = (P, P, P, I, I, I, I, I, I, I, P)
_IC_ARGS = (P, P, P, P, P, I, I, I, I, P)
_BWD_ARGS = (P, P, P, P, I, I, I, I, I, I, F, I, P)
_SSD_ARGS = (P, P, P, P, P, P, I, I, I, I, F, F, F, F, I, I, I, I, P)


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


@functools.lru_cache(maxsize=None)
def _sample_entry():
    """The bound C entry of :func:`sample_trilinear`, read once."""
    return _build.bind("warp", "sample_trilinear", _SAMPLE_ARGS)


def sample_trilinear(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (B, C, H, W, D) float32 or bfloat16 at normalized
    array-order coordinates ``grid`` (B, N, 3) float32 → (B, C, N) float32."""
    if vol.device.type == "cpu":
        return sample_trilinear_plain(vol, grid)
    _check_sampler_args(vol, grid, "sample_trilinear")
    B, C, H, W, D = vol.shape
    N = grid.shape[1]
    out = torch.empty((B, C, N), dtype=torch.float32, device=vol.device)
    err = _build.call_on(
        vol.device, _sample_entry(), vol.data_ptr(), grid.data_ptr(), out.data_ptr(), B, C, H, W,
        D, N, int(vol.dtype == torch.bfloat16),
    )
    _build.check(err, "sample_trilinear")
    LAUNCHES["sample_trilinear"] += 1
    return out


# ---------------------------------------------------------------------------
# inverse_consistency_steps
# ---------------------------------------------------------------------------

def _identity_axes(shape, device) -> "list[torch.Tensor]":
    """The identity grid's normalized coordinates per axis (align_corners=
    False voxel centres), the values ``identity_grid_normalized`` takes."""
    from convexadam_torch.core.warp import normalize_coord  # core imports this module

    return [normalize_coord(torch.arange(n, dtype=torch.float32, device=device), n, False)
            for n in shape]


def inverse_consistency_steps_plain(fields: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`inverse_consistency_steps`: per step
    the two displaced grids, one batched :func:`sample_trilinear_plain` of
    the swapped fields and the two updates."""
    d1, d2 = fields[0], fields[1]
    shape = tuple(d1.shape[1:])
    n = d1[0].numel()
    identity = torch.stack(torch.meshgrid(*_identity_axes(shape, fields.device), indexing="ij"), -1)
    for _ in range(iters):
        g1 = (identity + d1.permute(1, 2, 3, 0)).reshape(n, 3)
        g2 = (identity + d2.permute(1, 2, 3, 0)).reshape(n, 3)
        vol = torch.stack([d2, d1]).contiguous()
        out = sample_trilinear_plain(vol, torch.stack([g1, g2]))
        s1 = out[0].reshape((3,) + shape)  # d2 ∘ (id + d1)
        s2 = out[1].reshape((3,) + shape)  # d1 ∘ (id + d2)
        d1, d2 = 0.5 * (d1 - s1), 0.5 * (d2 - s2)
    return torch.stack([d1, d2])


def inverse_consistency_steps(fields: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Jacobi steps of inverse consistency on ``fields`` (2, 3, H,
    W, D) float32, ``[d1, d2]`` in normalized units: each step sets ``d1 =
    (d1 - d2 ∘ (id + d1)) / 2`` and ``d2 = (d2 - d1 ∘ (id + d2)) / 2`` from
    the previous step's fields (zeros padding, ``align_corners=False``).
    Returns a new (2, 3, H, W, D) tensor; ``fields`` is left as it is."""
    if fields.device.type == "cpu":
        return inverse_consistency_steps_plain(fields, iters)
    _build.require_cuda(fields, "inverse_consistency_steps")
    _build.require(fields, "inverse_consistency_steps fields", (torch.float32,),
                   (2, 3, None, None, None))
    if iters < 1:
        return fields.clone()
    H, W, D = fields.shape[2:]
    ih, iw, id_ = _identity_axes((H, W, D), fields.device)
    bufs = torch.empty((2,) + tuple(fields.shape), dtype=torch.float32, device=fields.device)
    err = _build.call_on(
        fields.device, _build.bind("warp", "inverse_consistency_steps", _IC_ARGS),
        fields.data_ptr(), bufs.data_ptr(), ih.data_ptr(), iw.data_ptr(), id_.data_ptr(),
        H, W, D, iters,
    )
    _build.check(err, "inverse_consistency_steps")
    LAUNCHES["sample_trilinear_ic"] += iters
    return bufs[(iters - 1) % 2]


# ---------------------------------------------------------------------------
# sample_trilinear_bwd
# ---------------------------------------------------------------------------

def sample_trilinear_bwd_plain(
    vol: torch.Tensor, grid: torch.Tensor, ct: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_trilinear_bwd`, in its order:
    per corner the channel sum ``cv = sum_c (ct * scale)_c * v_c`` first,
    then the rows ``sum_k g_k * cv_k``."""
    B, C = vol.shape[:2]
    flat = vol.reshape(B, C, -1)
    cs = ct * scale
    rows = None
    for lin, _, gx, gy, gz in _grid_corners(vol, grid, grads=True):
        prod = cs * _gather(flat, lin)
        cv = prod[:, 0]
        for c in range(1, C):
            cv = cv + prod[:, c]
        terms = (cv * gx, cv * gy, cv * gz)
        rows = terms if rows is None else tuple(r + t for r, t in zip(rows, terms))
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
    err = _build.call_on(
        vol.device, _build.bind("warp", "sample_trilinear_bwd", _BWD_ARGS), vol.data_ptr(),
        grid.data_ptr(), ct.data_ptr(), rows.data_ptr(), B, C, H, W, D, N,
        ctypes.c_float(scale), int(vol.dtype == torch.bfloat16),
    )
    _build.check(err, "sample_trilinear_bwd")
    LAUNCHES["sample_trilinear_bwd"] += 1
    return rows


# ---------------------------------------------------------------------------
# warp_ssd_loss_grad
# ---------------------------------------------------------------------------

def sub_extent(size: int, stride: int) -> int:
    """Points of ``range(0, size, stride)``: an axis of the strided lattice."""
    return -(-size // stride)


def _positions(disp: torch.Tensor, fac, stride: int = 1, row0: int = 0) -> "list[torch.Tensor]":
    """Sample positions ``stride * index + disp * fac`` per axis of the
    lattice ``disp`` (3, hs, ws, ds) covers, its first row the lattice's
    ``row0``, flattened (N,)."""
    _, hs, ws, ds = disp.shape
    out = []
    for a, n in enumerate((hs, ws, ds)):
        shape = [1, 1, 1]
        shape[a] = n
        first = row0 if a == 0 else 0
        idx = float(stride) * torch.arange(first, first + n, dtype=torch.float32,
                                           device=disp.device)
        idx = idx.reshape(shape)
        out.append((idx + disp[a] * fac[a]).reshape(-1))
    return out


def warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain, stride: int = 1, row0: int = 0):
    """Plain PyTorch version of :func:`warp_ssd_loss_grad`, in its order: per
    channel the sample ``s = sum_k w_k v_k`` and the residual, then per
    corner the channel sum ``cv_k = sum_c (res_c * chain) * v_{k,c}``, then
    the rows ``sum_k g_k * cv_k``."""
    C, H, W, D = mov.shape
    axes = [_split(p) for p in _positions(disp, fac, stride, row0)]
    flat = mov.float().reshape(C, H * W * D)
    corners = _corners(axes, H, W, D, grads=True)
    vals = [flat[:, lin] for lin, *_ in corners]
    s = None
    for v, (_, w, *_) in zip(vals, corners):
        s = v * w if s is None else s + v * w
    res = s - fix_flat
    ssq = (res * res).sum()
    ct = res * chain
    rows = None
    for v, (_, _, gx, gy, gz) in zip(vals, corners):
        prod = ct * v
        cv = prod[0]
        for c in range(1, C):
            cv = cv + prod[c]
        terms = (cv * gx, cv * gy, cv * gz)
        rows = terms if rows is None else tuple(r + t for r, t in zip(rows, terms))
    return ssq, torch.stack(rows)


@functools.lru_cache(maxsize=None)
def _ssd_entry():
    """The bound C entry of :func:`warp_ssd_loss_grad` and its CTA size (one
    partial sum per CTA), read once."""
    return (_build.bind("warp", "warp_ssd_loss_grad", _SSD_ARGS),
            _build.bind("warp", "warp_ssd_threads", ())())


def warp_ssd_loss_grad(mov, disp, fix_flat, fac, chain: float, stride: int = 1, row0: int = 0):
    """Adam data term of the moving features ``mov`` (C, H, W, D) float32 or
    bfloat16, sampled at ``stride * index + disp * fac`` (``fac`` three
    floats) for the points of the ``(::stride,)*3`` sub-lattice of the grid
    (the whole grid for ``stride`` 1): disp (3, hs, ws, ds) float32 with
    ``hs = ceil(H / stride)`` and so on, against ``fix_flat`` (C, N)
    float32, N = hs * ws * ds.  With ``row0`` > 0, or fewer rows ``hs``,
    ``disp`` and ``fix_flat`` hold only the lattice rows ``row0 .. row0 +
    hs - 1`` (the index along H is ``row0 + i``), the rest as before.

    Returns ``(ssq, rows)``: the 0-dim float32 ``sum(res^2)`` and the (3, N)
    float32 gradient rows of ``sum(res^2) * chain / 2`` with respect to the
    sample positions.  A strided launch counts as
    ``warp_ssd_loss_grad_strided``.
    """
    if mov.device.type == "cpu":
        return warp_ssd_loss_grad_plain(mov, disp, fix_flat, fac, chain, stride, row0)
    _build.require_cuda(mov, "warp_ssd_loss_grad")
    _build.require(mov, "warp_ssd_loss_grad mov", (torch.float32, torch.bfloat16), (None,) * 4)
    C, H, W, D = mov.shape
    if stride < 1:
        raise ValueError(f"warp_ssd_loss_grad: stride {stride} < 1")
    _build.require(disp, "warp_ssd_loss_grad disp", (torch.float32,),
                   (3, None, sub_extent(W, stride), sub_extent(D, stride)))
    hs, ws, ds = disp.shape[1:]
    if row0 < 0 or row0 + hs > sub_extent(H, stride):
        raise ValueError(f"warp_ssd_loss_grad: lattice rows {row0}..{row0 + hs - 1} outside "
                         f"0..{sub_extent(H, stride) - 1}")
    N = hs * ws * ds
    _build.require(fix_flat, "warp_ssd_loss_grad fix", (torch.float32,), (C, N))
    if disp.device != mov.device or fix_flat.device != mov.device:
        raise ValueError("warp_ssd_loss_grad: all tensors must lie on one device")
    fn, threads = _ssd_entry()
    parts = -(-N // threads)
    # one allocation: the rows, the per-CTA partials, the total
    buf = torch.empty((3 * N + parts + 1,), dtype=torch.float32, device=mov.device)
    ptr = buf.data_ptr()
    err = _build.call_on(
        mov.device, fn, mov.data_ptr(), disp.data_ptr(), fix_flat.data_ptr(), ptr,
        ptr + 4 * 3 * N, ptr + 4 * (3 * N + parts), C, H, W, D, fac[0], fac[1], fac[2], chain,
        stride, int(mov.dtype == torch.bfloat16), row0, hs,
    )
    _build.check(err, "warp_ssd_loss_grad")
    LAUNCHES["warp_ssd_loss_grad_strided" if stride > 1 else "warp_ssd_loss_grad"] += 1
    return buf[3 * N + parts], buf[: 3 * N].view(3, N)
