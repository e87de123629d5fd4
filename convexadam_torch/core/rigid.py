"""Rigid fitting and thin-plate-spline densification.

Counterpart of ``convexadam_tpu/core/rigid.py``:

* Kabsch SVD rigid fit (:func:`find_rigid_3d`);
* least-trimmed-squares robust rigid fit (:func:`least_trimmed_rigid`) and
  its use on a dense displacement field (:func:`rigid_from_field`, the
  CuRIOUS rigid extraction);
* thin-plate splines through sparse correspondences (:func:`tps_fit`,
  :func:`tps_eval`) and the dense field they give (:func:`thin_plate_dense`,
  task 1's densification).

The systems are small and precision-critical, so every function runs its
products in full float32: TF32 is switched off for matmuls and cuDNN for the
call and the caller's settings are restored after it (the JAX package forces
float32 matmul precision for the same reason).  The functions take tensors
and run on their device; the decompositions are ``torch.linalg``'s, as the
JAX package leaves them to ``jnp.linalg``.
"""

from __future__ import annotations

import functools

import torch

from convexadam_torch.core.warp import identity_grid_normalized, resize_trilinear
from convexadam_torch.utils import trace


def _f32_matmuls(fn):
    """Run ``fn`` with full-float32 matmuls and convolutions (no TF32),
    restoring the caller's settings afterwards."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        precision = torch.get_float32_matmul_precision()
        cudnn_tf32 = torch.backends.cudnn.allow_tf32
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_float32_matmul_precision(precision)
            torch.backends.cudnn.allow_tf32 = cudnn_tf32

    return wrapped


@_f32_matmuls
def find_rigid_3d(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kabsch: the rigid 4x4 float32 transform T with y ≈ T @ x (points (N,
    3) or (N, 4) homogeneous; only the first three columns are used)."""
    x3 = x[:, :3].float()
    y3 = y[:, :3].float()
    x_mean = x3.mean(dim=0)
    y_mean = y3.mean(dim=0)
    u, _, vt = torch.linalg.svd((x3 - x_mean).T @ (y3 - y_mean))
    v = vt.T
    m = torch.eye(3, dtype=torch.float32, device=x3.device)
    m[-1, -1] = torch.linalg.det(v @ u.T)
    rotation = v @ m @ u.T
    translation = y_mean - rotation @ x_mean
    T = torch.eye(4, dtype=torch.float32, device=x3.device)
    T[:3, :3] = rotation
    T[:3, 3] = translation
    return T


@_f32_matmuls
def least_trimmed_rigid(
    fixed_pts: torch.Tensor, moving_pts: torch.Tensor, iters: int = 5
) -> torch.Tensor:
    """Robust rigid fit: fit on every point, then ``iters - 1`` times refit
    on the half of the points with the smallest residuals.  Points are (N,
    4) homogeneous; returns the 4x4 transform with moving ≈ fixed @ T^T.
    Only the kept set matters, so ``torch.topk`` takes ``lax.top_k``'s
    place whatever order it returns."""
    fixed_pts = fixed_pts.float()
    moving_pts = moving_pts.float()
    k = fixed_pts.shape[0] // 2

    def fit(fp, mp):
        x = find_rigid_3d(fp, mp).T
        residual = torch.sqrt(((moving_pts - fixed_pts @ x) ** 2).sum(dim=1))
        return x, torch.topk(residual, k, largest=False).indices

    x, idx = fit(fixed_pts, moving_pts)
    for _ in range(iters - 1):
        x, idx = fit(fixed_pts[idx], moving_pts[idx])
    return x.T


@_f32_matmuls
def rigid_from_field(
    disp: torch.Tensor,
    mask: "torch.Tensor | None" = None,
    num_samples: int = 4096,
    seed: int = 0,
    iters: int = 5,
) -> torch.Tensor:
    """A robust rigid transform from a dense displacement field ``disp`` (3,
    H, W, D) in voxels: ``num_samples`` voxel positions drawn with
    replacement (in proportion to ``mask`` where given, else uniformly),
    paired with their displaced positions, and fitted by
    :func:`least_trimmed_rigid`.  Returns a 4x4 float32 transform in voxel
    coordinates (array order), on ``disp``'s device.

    The draws come from a ``torch.Generator`` on that device seeded with
    ``seed``, so they are not the JAX package's.  Under a mask they invert
    the mask's cumulative sum (``torch.multinomial`` takes at most 2^24
    categories, fewer than a 256 x 256 x 288 volume has voxels).
    """
    H, W, D = disp.shape[1:]
    dev = disp.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mask is not None:
        cdf = torch.cumsum(mask.reshape(-1).double(), dim=0)
        u = torch.rand(num_samples, dtype=torch.float64, generator=gen, device=dev) * cdf[-1]
        idx = torch.searchsorted(cdf, u, right=True).clamp_(max=cdf.numel() - 1)
    else:
        idx = torch.randint(0, H * W * D, (num_samples,), generator=gen, device=dev)
    fixed = torch.stack([idx // (W * D), (idx // D) % W, idx % D], dim=1).float()
    moving = fixed + disp.reshape(3, -1)[:, idx].T.float()
    ones = torch.ones((num_samples, 1), dtype=torch.float32, device=dev)
    return least_trimmed_rigid(torch.cat([fixed, ones], 1), torch.cat([moving, ones], 1),
                               iters=iters)


# ---------------------------------------------------------------------------
# thin plate splines
# ---------------------------------------------------------------------------

def _tps_u(r: torch.Tensor) -> torch.Tensor:
    return (r**2) * torch.log(r + 1e-6)


def _tps_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ra = (a**2).sum(dim=1)[:, None]
    rb = (b**2).sum(dim=1)[None, :]
    return torch.sqrt(torch.clamp(ra + rb - 2.0 * (a @ b.T), min=0.0))


@_f32_matmuls
def tps_fit(c: torch.Tensor, f: torch.Tensor, lambd: float = 0.0) -> torch.Tensor:
    """TPS coefficients (N + 4, F) mapping control points ``c`` (N, 3) to
    values ``f`` (N, F)."""
    c = c.float()
    n = c.shape[0]
    dev = c.device
    K = _tps_u(_tps_dist(c, c)) + torch.eye(n, dtype=torch.float32, device=dev) * lambd
    P = torch.cat([torch.ones((n, 1), dtype=torch.float32, device=dev), c], dim=1)
    A = torch.zeros((n + 4, n + 4), dtype=torch.float32, device=dev)
    A[:n, :n] = K
    A[:n, n:] = P
    A[n:, :n] = P.T
    v = torch.zeros((n + 4, f.shape[1]), dtype=torch.float32, device=dev)
    v[:n] = f.float()
    return torch.linalg.solve(A, v)


@_f32_matmuls
def tps_eval(x: torch.Tensor, c: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """A fitted TPS (:func:`tps_fit`) at points ``x`` (M, 3) → (M, F)."""
    x = x.float()
    U = _tps_u(_tps_dist(x, c.float()))
    w, a = theta[:-4], theta[-4:]
    b = U @ w
    return (a[0][None, :] + x[:, 0:1] * a[1][None, :] + x[:, 1:2] * a[2][None, :]
            + x[:, 2:3] * a[3][None, :] + b)


@_f32_matmuls
def thin_plate_dense(
    x1: torch.Tensor,
    y1: torch.Tensor,
    shape: "tuple[int, int, int]",
    step: int,
    lambd: float = 0.0,
) -> torch.Tensor:
    """Densify sparse displacements: control points ``x1`` (N, 3) in
    normalized array-order coordinates with values ``y1`` (N, 3) → the
    field (H, W, D, 3), the TPS evaluated on a ``step``-strided grid
    (align_corners=True coordinates) and upsampled trilinearly."""
    H, W, D = shape
    sub = (H // step, W // step, D // step)
    x2 = identity_grid_normalized(sub, align_corners=True, device=x1.device).reshape(-1, 3)
    with trace.span("tps.fit"):
        theta = tps_fit(x1, y1, lambd)
    with trace.span("tps.eval"):
        y2 = tps_eval(x2, x1, theta).reshape(*sub, 3).permute(3, 0, 1, 2)
        y2 = resize_trilinear(y2, (H, W, D), align_corners=True)
        return y2.permute(1, 2, 3, 0)
