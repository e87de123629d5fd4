"""Adam instance optimisation, the local continuous refinement stage.

Counterpart of ``convexadam_tpu/core/adam.py``.  The only trainable tensor
is a low-resolution displacement grid.  Each iteration smooths the raw grid,
adds the diffusion regulariser to the warp + SSD data term, back-propagates
with ordinary autograd, and takes a ``torch.optim.Adam`` step with ``lr=1``.

Two gradient steps share that loop body (:func:`_adam_loop`), as in the JAX
module: :func:`_grad_step_fused`, whose data term is the fused kernel
(:func:`convexadam_torch.core.warp.warp_ssd_mean_loss`, one launch), and
:func:`_grad_step_autodiff`, which differentiates the unfused data term
through the sampler's forward and backward kernels.
:func:`adam_instance_optimisation` takes the fused step on every device.
"""

from __future__ import annotations

import torch

from convexadam_torch.core.smoothing import (
    box_smooth_repeated,
    gaussian_kernel_1d,
    gaussian_smooth,
    kovesi_spline,
    kovesi_widths,
)
from convexadam_torch.core.warp import warp_ssd_mean_loss, warp_ssd_mean_loss_unfused
from convexadam_torch.utils import trace

# stage-2 "shift-spline" smoother bank: two Gaussians and six Kovesi
# box-cascade splines, indexed by ``avg_n``
SMOOTHER_BANK: "tuple[tuple, ...]" = (
    ("gauss", 0.7),
    ("gauss", 1.0),
    ("kovesi", 1.3),
    ("kovesi", 1.6),
    ("kovesi", 1.9),
    ("kovesi", 2.2),
    ("kovesi", 2.5),
    ("kovesi", 2.8),
)


def resolve_smoother(spec: tuple):
    """Smoother spec → callable: ("box", kernel, repeats), ("gauss", sigma),
    ("kovesi", sigma[, n]) or ("bank", avg_n)."""
    kind = spec[0]
    if kind == "box":
        _, kernel, repeats = spec
        return lambda x: box_smooth_repeated(x, kernel, repeats)
    if kind == "gauss":
        return lambda x: gaussian_smooth(x, spec[1])
    if kind == "kovesi":
        n = spec[2] if len(spec) > 2 else 4
        return lambda x: kovesi_spline(x, spec[1], n)
    if kind == "bank":
        return resolve_smoother(SMOOTHER_BANK[spec[1]])
    raise ValueError(f"unknown smoother spec: {spec}")


def smoother_reach(spec: tuple) -> int:
    """Rows on either side of a voxel that :func:`resolve_smoother`'s
    smoother of ``spec`` reads."""
    kind = spec[0]
    if kind == "box":
        return spec[2] * (spec[1] // 2)
    if kind == "gauss":
        return len(gaussian_kernel_1d(spec[1])) // 2
    if kind == "kovesi":
        return sum((w - 1) // 2 for w in kovesi_widths(spec[1], spec[2] if len(spec) > 2 else 4))
    if kind == "bank":
        return smoother_reach(SMOOTHER_BANK[spec[1]])
    raise ValueError(f"unknown smoother spec: {spec}")


def diffusion_regularizer(disp: torch.Tensor, counts=None) -> torch.Tensor:
    """Mean squared forward differences of ``disp`` (3, H, W, D) along each
    spatial axis, each averaged over its own element count, summed.
    ``counts`` (three ints) replaces the element counts: a slab of a field
    split along H divides its sums by the whole field's, which gives each
    voxel the whole field's gradient."""
    dh = disp[:, 1:, :, :] - disp[:, :-1, :, :]
    dw = disp[:, :, 1:, :] - disp[:, :, :-1, :]
    dd = disp[:, :, :, 1:] - disp[:, :, :, :-1]
    if counts is None:
        return (dh * dh).mean() + (dw * dw).mean() + (dd * dd).mean()
    return (dh * dh).sum() / counts[0] + (dw * dw).sum() / counts[1] + (dd * dd).sum() / counts[2]


def _sub_lattice(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(C, h, w, d) → the ``(::stride,)*3`` spatial sub-lattice (a view)."""
    return x if stride == 1 else x[:, ::stride, ::stride, ::stride]


def _value_and_grad(data_term, w, fix_flat, mov, lambda_weight, smooth_fn, cost_scale,
                    counts=None):
    """``(loss, smoothed field, d loss / d w)`` of smoother → regulariser +
    ``data_term``, all detached."""
    ds = smooth_fn(w)
    reg = lambda_weight * diffusion_regularizer(ds, counts)
    loss = data_term(mov, ds, fix_flat, cost_scale) + reg
    (g,) = torch.autograd.grad(loss, w)
    return loss.detach(), ds.detach(), g


def _grad_step_fused(w, fix_flat, mov, lambda_weight, smooth_fn, cost_scale, stride=1,
                     slab=None):
    """One gradient evaluation with the fused data-term kernel.  With
    ``stride`` > 1 the data term sees the ``(::stride,)*3`` sub-lattice of
    the smoothed field (``fix_flat`` holds the sub-lattice's fixed
    features); the slice's backward puts its gradient back onto the full
    grid with zeros between the samples before the smoother's, as the JAX
    package's explicit step does.  ``slab`` (row0, n_points, counts) makes
    ``w`` the rows of a field split along H from its lattice row ``row0``:
    the data term and the regulariser then divide by the whole field's
    counts."""
    row0, n_points, counts = slab or (0, None, None)

    def data_term(mov, ds, fix_flat, cost_scale):
        return warp_ssd_mean_loss(mov, _sub_lattice(ds, stride), fix_flat, cost_scale, stride,
                                  row0, n_points)

    return _value_and_grad(data_term, w, fix_flat, mov, lambda_weight, smooth_fn, cost_scale,
                           counts)


def _grad_step_autodiff(w, fix_flat, mov, lambda_weight, smooth_fn, cost_scale):
    """One gradient evaluation through the differentiable warp: the
    sampler's forward kernel, then its coordinate-gradient kernel."""
    return _value_and_grad(
        warp_ssd_mean_loss_unfused, w, fix_flat, mov, lambda_weight, smooth_fn, cost_scale
    )


def _adam_loop(grad_fn, disp_init, niter, snapshot_iters=()):
    """``niter`` Adam steps (``lr=1``) of ``w`` from ``disp_init`` with the
    gradient ``grad_fn(w) -> (loss, smoothed field, grad)``.  Returns the
    smoothed field of the last loop body and the snapshot stack of
    :func:`adam_instance_optimisation`."""
    w = disp_init.float().clone().requires_grad_(True)
    opt = torch.optim.Adam([w], lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    final = torch.zeros_like(w, requires_grad=False)
    snaps = torch.zeros((len(snapshot_iters),) + tuple(w.shape), dtype=torch.float32, device=w.device)
    for it in range(niter):
        _, final, w.grad = grad_fn(w)
        opt.step()
        for si, k in enumerate(snapshot_iters):
            if k - 1 == it:
                snaps[si] = final
    return final, snaps


def adam_instance_optimisation(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_init: torch.Tensor,
    lambda_weight: float,
    niter: int,
    snapshot_iters: "tuple[int, ...]" = (),
    smoother: tuple = ("box", 3, 3),
    cost_scale: float = 12.0,
    sample_stride: int = 1,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Optimise a low-resolution displacement grid against pooled features.

    ``feat_fix`` (C, h, w, d) is used in float32, ``feat_mov`` in its own
    dtype (float32 or bfloat16); ``disp_init`` (3, h, w, d) is in coarse
    voxels.  Returns ``(final, snapshots)``: the smoothed field computed in
    the last loop body, before its update (the reference's output), and a
    (len(snapshot_iters), 3, h, w, d) stack whose entry for ``k`` is the
    smoothed field of loop body ``k - 1``.  Every step is
    :func:`_grad_step_fused`.

    ``sample_stride`` > 1 evaluates the data term on the
    ``(::sample_stride,)*3`` sub-lattice of the Adam grid only (the JAX
    package's opt-in speed knob: s^3 fewer gathers); the smoother, the
    regulariser and the field stay full-resolution.
    """
    if sample_stride < 1:
        raise ValueError(f"sample_stride {sample_stride} < 1")
    C = feat_fix.shape[0]
    fix_flat = _sub_lattice(feat_fix.float(), sample_stride).reshape(C, -1).contiguous()
    mov = feat_mov.contiguous()
    smooth_fn = resolve_smoother(smoother)

    def grad_fn(w):
        return _grad_step_fused(w, fix_flat, mov, lambda_weight, smooth_fn, cost_scale,
                                sample_stride)

    with trace.span("adam.loop"):
        trace.count("adam.steps", niter)
        return _adam_loop(grad_fn, disp_init, niter, snapshot_iters)
