"""The ConvexAdam registration pipeline.

Counterpart of ``convexadam_tpu/pipeline/convex_adam.py``:

  1. MIND-SSC features of both volumes (:func:`convex_adam_torch`), or
     weighted nnU-Net one-hot features of two label volumes
     (:func:`convex_adam_semantic_torch`),
  2. average pooling to the coarse grid ``grid_sp``,
  3. the dense SSD cost volume over ``(2*disp_hw+1)**3`` displacements,
  4. coupled convex optimisation,
  5. optional inverse consistency with the reverse-direction field,
  6. optional Adam instance optimisation at ``grid_sp_adam`` resolution,
  7. optional cascaded box smoothing of the full-resolution field.

:func:`convex_adam_semantic_from_images` puts the segmentation front end
(:mod:`convexadam_torch.models`) before the semantic pipeline, so that it
runs from raw intensity volumes.

Like the JAX package, ``ic=False`` upsamples the coarse field and rescales
it by ``grid_sp`` instead of returning coarse-voxel units.
:func:`convex_adam_multi_output` runs stages 2-7 once and returns the fields
of several iteration counts and final smoothings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.adam import adam_instance_optimisation
from convexadam_torch.core.convex import convex_displacement
from convexadam_torch.core.features import mindssc, nnunet_norm, semantic_features
from convexadam_torch.core.smoothing import avg_pool3d, box_smooth_repeated
from convexadam_torch.core.warp import inverse_consistency, resize_trilinear
from convexadam_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class ConvexAdamConfig:
    """Hyperparameters; defaults are the reference CLI's.  The fields and
    their meaning are those of the JAX package's ``ConvexAdamConfig``."""

    mind_r: int = 1
    mind_d: int = 2
    lambda_weight: float = 1.25
    grid_sp: int = 6
    disp_hw: int = 4
    selected_niter: int = 80
    selected_smooth: int = 0
    grid_sp_adam: int = 2
    ic: bool = True
    cost_metric: str = "ssd"
    cost_smooth_passes: int = 2
    adam_smoother: tuple = ("box", 3, 3)
    # "auto" (bfloat16 on CUDA, float32 on the CPU), "float32" or "bfloat16"
    dtype: str = "auto"
    snapshot_iters: "tuple[int, ...]" = ()
    adam_sample_stride: int = 1

    def compute_dtype(self, device: torch.device) -> torch.dtype:
        """Feature dtype on ``device``: ``"auto"`` is bfloat16 on CUDA, the
        JAX package's accelerator policy, so its bf16 envelopes transfer."""
        if self.dtype == "auto":
            return torch.bfloat16 if device.type == "cuda" else torch.float32
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def check_grids(cfg: ConvexAdamConfig, shape, convex: bool = True, adam: bool = False) -> None:
    """Raise unless the coarse grid (with ``convex``) and the Adam grid (with
    ``adam``) of a volume of ``shape`` have at least 2 cells along every
    axis."""
    H, W, D = shape
    g = cfg.grid_sp
    if convex and min(H // g, W // g, D // g) < 2:
        raise ValueError(
            f"grid_sp={g} leaves a coarse grid of {(H // g, W // g, D // g)} for "
            f"volume {tuple(shape)}; every coarse axis needs >= 2 cells"
        )
    g2 = cfg.grid_sp_adam
    if adam and min(H // g2, W // g2, D // g2) < 2:
        raise ValueError(
            f"grid_sp_adam={g2} leaves an Adam grid of {(H // g2, W // g2, D // g2)} "
            f"for volume {tuple(shape)}; every axis needs >= 2 cells"
        )


def _convex_stage(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    cfg: ConvexAdamConfig,
    full_shape: "tuple[int, int, int]",
    for_adam_init: bool = False,
    coarse: bool = False,
) -> torch.Tensor:
    """Pooling, cost volume, coupled convex and inverse consistency.

    Returns the displacement (3, H, W, D) in full-resolution voxels; with
    ``for_adam_init`` and ``ic=False`` it stays on the coarse grid, so that
    one resize takes it to the Adam grid; with ``coarse`` it stays there in
    either case (the sweep's stage-2 cache), still in full-resolution voxels.
    """
    g = cfg.grid_sp
    check_grids(cfg, full_shape)
    with trace.span("convex.pool"):
        fix_s, mov_s = avg_pool3d(feat_fix, g, stride=g), avg_pool3d(feat_mov, g, stride=g)
    return _convex_pooled(fix_s, mov_s, cfg, full_shape, for_adam_init, coarse)


def _convex_pooled(
    fix_s: torch.Tensor,
    mov_s: torch.Tensor,
    cfg: ConvexAdamConfig,
    full_shape: "tuple[int, int, int]",
    for_adam_init: bool = False,
    coarse: bool = False,
) -> torch.Tensor:
    """:func:`_convex_stage` from the features pooled by ``grid_sp``, so
    that a caller may drop the full-resolution ones before the cost
    volume."""
    H, W, D = full_shape
    g = cfg.grid_sp
    kw = dict(metric=cfg.cost_metric, smooth_passes=cfg.cost_smooth_passes)
    disp_soft = convex_displacement(fix_s, mov_s, cfg.disp_hw, **kw)
    if cfg.ic:
        h, w, d = disp_soft.shape[1:]
        with trace.span("convex.ic"):
            scale = torch.tensor(
                [(h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0], dtype=torch.float32,
                device=disp_soft.device,
            ).reshape(3, 1, 1, 1)
        disp_soft_r = convex_displacement(mov_s, fix_s, cfg.disp_hw, **kw)
        with trace.span("convex.ic"):
            disp_ice, _ = inverse_consistency(disp_soft / scale, disp_soft_r / scale, iters=15)
            disp_lr = disp_ice * scale * g
        if coarse:
            return disp_lr
        with trace.span("convex.upsample"):
            return resize_trilinear(disp_lr, (H, W, D), align_corners=False)
    if for_adam_init or coarse:
        return disp_soft * g
    with trace.span("convex.upsample"):
        return resize_trilinear(disp_soft * g, (H, W, D), align_corners=False)


def _adam_inputs(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hr: torch.Tensor,
    cfg: ConvexAdamConfig,
) -> "tuple[torch.Tensor, torch.Tensor, torch.Tensor]":
    """The Adam stage's pooled fixed (float32) and moving (compute dtype)
    features and its init (3, h, w, d) in Adam-grid voxels, from the init
    ``disp_hr`` in full-resolution voxels at any resolution."""
    H, W, D = feat_fix.shape[1:]
    g2 = cfg.grid_sp_adam
    check_grids(cfg, (H, W, D), convex=False, adam=True)
    patch_fix = avg_pool3d(feat_fix.float(), g2, stride=g2)
    # the moving features stay in the compute dtype (bf16 halves the data
    # term's gather traffic); the kernel accumulates in float32 either way
    patch_mov = avg_pool3d(feat_mov.float(), g2, stride=g2).to(cfg.compute_dtype(feat_fix.device))
    disp_lr = resize_trilinear(disp_hr, (H // g2, W // g2, D // g2), align_corners=False)
    return patch_fix, patch_mov, disp_lr / g2


def _upsample_and_smooth(field: torch.Tensor, shape, g2: int, k: int) -> torch.Tensor:
    """An Adam-grid field (3, h, w, d) to full-resolution voxels, then ``k``
    (0 = none) cascaded 3-pass box smoothing; an even ``k`` is rounded up,
    as the reference warns for even kernels."""
    out = resize_trilinear(field * g2, shape, align_corners=False)
    if k > 0:
        if k % 2 == 0:
            k += 1
        out = box_smooth_repeated(out, k, 3)
    return out


def _adam_stage(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hr: torch.Tensor,
    cfg: ConvexAdamConfig,
) -> "tuple[torch.Tensor, torch.Tensor]":
    """Instance optimisation and final smoothing.  ``disp_hr`` is the init
    in full-resolution voxels at any resolution; returns the final field
    (3, H, W, D) and the snapshot fields (S, 3, H, W, D) in voxels."""
    shape = tuple(feat_fix.shape[1:])
    patch_fix, patch_mov, init = _adam_inputs(feat_fix, feat_mov, disp_hr, cfg)
    fitted, snaps = adam_instance_optimisation(
        patch_fix, patch_mov, init,
        lambda_weight=cfg.lambda_weight, niter=cfg.selected_niter,
        snapshot_iters=cfg.snapshot_iters, smoother=cfg.adam_smoother,
        sample_stride=cfg.adam_sample_stride,
    )
    g2, k = cfg.grid_sp_adam, cfg.selected_smooth
    final = _upsample_and_smooth(fitted, shape, g2, k)
    snaps_hr = torch.stack([_upsample_and_smooth(s, shape, g2, k) for s in snaps]) if len(snaps) else (
        torch.zeros((0, 3) + shape, dtype=torch.float32, device=final.device)
    )
    return final, snaps_hr


def convex_adam_features(
    feat_fix: torch.Tensor, feat_mov: torch.Tensor, cfg: ConvexAdamConfig
) -> torch.Tensor:
    """Stages 2-7 on full-resolution features (C, H, W, D) → the
    displacement field (H, W, D, 3) in voxels, channels in array order."""
    H, W, D = feat_fix.shape[1:]
    run_adam = cfg.lambda_weight > 0
    with torch.no_grad():
        disp_hr = _convex_stage(feat_fix, feat_mov, cfg, (H, W, D), for_adam_init=run_adam)
    if run_adam:
        disp_hr, _ = _adam_stage(feat_fix, feat_mov, disp_hr, cfg)
    return disp_hr.detach().permute(1, 2, 3, 0)


def convex_adam_torch(
    img_fixed: torch.Tensor,
    img_moving: torch.Tensor,
    cfg: ConvexAdamConfig = ConvexAdamConfig(),
) -> torch.Tensor:
    """The MIND pipeline on intensity volumes (H, W, D), on their device.

    Returns the displacement field (H, W, D, 3) in voxels (dH, dW, dD).
    """
    dt = cfg.compute_dtype(img_fixed.device)
    with torch.no_grad():
        feat_fix = mindssc(img_fixed.float(), cfg.mind_r, cfg.mind_d, dtype=dt)
        feat_mov = mindssc(img_moving.float(), cfg.mind_r, cfg.mind_d, dtype=dt)
    return convex_adam_features(feat_fix, feat_mov, cfg)


def convex_adam_semantic_torch(
    pred_fixed,
    pred_moving,
    cfg: ConvexAdamConfig = ConvexAdamConfig(),
    num_labels: int = 2,
    mult: float = 10.0,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """The nnU-Net semantic pipeline on integer label volumes (H, W, D),
    numpy arrays or tensors: :func:`semantic_features` (``num_labels``
    one-hot channels weighted by inverse label frequency, times ``mult``) in
    the compute dtype, then :func:`convex_adam_features`.  Runs on ``cuda``
    unless ``device="cpu"``; raises when no GPU is visible and no device is
    given.

    Returns the displacement field (H, W, D, 3) in voxels (dH, dW, dD), a
    tensor on that device.
    """
    dev = _resolve_device(device)
    pred_fixed, pred_moving = (torch.as_tensor(p).to(dev) for p in (pred_fixed, pred_moving))
    dt = cfg.compute_dtype(dev)
    with torch.no_grad():
        feat_fix, feat_mov = semantic_features(
            pred_fixed, pred_moving, num_labels=num_labels, mult=mult, dtype=dt
        )
    return convex_adam_features(feat_fix, feat_mov, cfg)


def convex_adam_multi_output(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    cfg: ConvexAdamConfig = ConvexAdamConfig(),
    iters: "tuple[int, ...]" = (40, 60, 80),
    smoothings: "tuple[int, ...]" = (0, 3, 5),
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """One convex stage and one Adam run of ``max(iters)`` iterations on
    features (C, H, W, D); the field after every count in ``iters`` is
    upsampled and smoothed with every cascade in ``smoothings`` (0 = none,
    else the triple k^3 box; an even k is rounded up).  Runs on ``cuda``
    unless ``device="cpu"``; raises when no GPU is visible and no device is
    given.

    Returns (len(iters), len(smoothings), H, W, D, 3) in voxels, a tensor on
    that device: the self-configuring pipeline's 9 = {40, 60, 80} x
    {0, 3, 5} variants by default.  The Adam stage always runs
    (``cfg.lambda_weight`` is only its weight).
    """
    dev = _resolve_device(device)
    feat_fix, feat_mov = feat_fix.to(dev), feat_mov.to(dev)
    shape = tuple(feat_fix.shape[1:])
    with torch.no_grad():
        disp_init = _convex_stage(feat_fix, feat_mov, cfg, shape, for_adam_init=True)
    patch_fix, patch_mov, init = _adam_inputs(feat_fix, feat_mov, disp_init, cfg)
    _, snaps = adam_instance_optimisation(
        patch_fix, patch_mov, init, lambda_weight=cfg.lambda_weight, niter=max(iters),
        snapshot_iters=tuple(iters), smoother=cfg.adam_smoother,
    )
    g2 = cfg.grid_sp_adam
    return torch.stack([
        torch.stack([_upsample_and_smooth(snap, shape, g2, k).permute(1, 2, 3, 0)
                     for k in smoothings])
        for snap in snaps
    ])


def validate_volume(img) -> np.ndarray:
    """numpy arrays, tensors, ``MedicalImage``, nibabel spatial images,
    SimpleITK images, or anything with ``__array__`` (a ``jax.Array``) →
    a float32 numpy volume (the reference's ``validate_image`` adapter,
    convex_adam_utils.py:268-279, and the JAX package's
    ``validate_volume``).

    nibabel and SimpleITK are duck-typed (neither is a dependency): a
    nibabel image has ``get_fdata``; a SimpleITK image goes through the
    ``GetArrayFromImage`` of the module that defines its class, so the
    caller's own SimpleITK is used, and comes out in (z, y, x) order, as the
    reference's ``sitk.GetArrayFromImage`` branch gives it."""
    import sys

    from convexadam_torch.geometry.image import MedicalImage

    if isinstance(img, MedicalImage):
        return np.asarray(img.data, np.float32)
    if isinstance(img, np.ndarray):
        return np.asarray(img, np.float32)
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().float().numpy()
    # nibabel SpatialImage (convex_adam_utils.py:276-277)
    if hasattr(img, "get_fdata"):
        return np.asarray(img.get_fdata(), np.float32)
    # SimpleITK Image (convex_adam_utils.py:272-273)
    mod = sys.modules.get(type(img).__module__)
    if mod is not None and hasattr(mod, "GetArrayFromImage"):
        return np.asarray(mod.GetArrayFromImage(img), np.float32)
    # a jax.Array, or any other array that numpy can read
    if hasattr(img, "__array__"):
        return np.asarray(img, np.float32)
    raise ValueError(
        "Input image must be a numpy array, a torch tensor, a MedicalImage, a "
        "nibabel or SimpleITK image, or an array with __array__ (a jax.Array)"
    )


def convex_adam(
    img_fixed,
    img_moving,
    cfg: Optional[ConvexAdamConfig] = None,
    device: "str | torch.device | None" = None,
    **overrides,
) -> np.ndarray:
    """Host-level entry point: any volume :func:`validate_volume` takes in,
    numpy field (H, W, D, 3) out.  Runs on ``cuda`` unless ``device="cpu"``; raises when
    no GPU is visible and no device is given.  ``overrides`` are
    :class:`ConvexAdamConfig` fields (e.g. ``grid_sp=4``)."""
    dev = _resolve_device(device)
    if cfg is None:
        cfg = ConvexAdamConfig(**overrides)
    elif overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    f = torch.from_numpy(validate_volume(img_fixed)).to(dev)
    m = torch.from_numpy(validate_volume(img_moving)).to(dev)
    out = convex_adam_torch(f, m, cfg)
    return out.cpu().numpy().astype(np.float32, copy=False)


def convex_adam_semantic_from_images(
    img_fixed,
    img_moving,
    predict_logits,
    patch_size,
    cfg: "ConvexAdamConfig | None" = None,
    num_labels: "int | None" = None,
    mult: float = 10.0,
    normalize: bool = True,
    step_size: float = 0.5,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Semantic registration from raw intensity volumes (the JAX package's
    entry of the same name): :func:`validate_volume`, nnU-Net intensity
    normalisation (:func:`~convexadam_torch.core.features.nnunet_norm`,
    unless ``normalize=False``), Gaussian-blended sliding-window labels of
    both volumes (``predict_logits`` maps patches (B, h, w, d) to logits
    (B, C, h, w, d), e.g. :func:`~convexadam_torch.models.make_predictor`),
    then :func:`convex_adam_semantic_torch` with ``num_labels`` one-hot
    channels (by default the largest predicted label + 1).  The labels stay
    on the device.  Runs on ``cuda`` unless ``device="cpu"``.

    Returns the displacement field (H, W, D, 3) in voxels, a numpy array.
    """
    from convexadam_torch.models.segmentation import predict_labels

    dev = _resolve_device(device)
    if cfg is None:
        cfg = ConvexAdamConfig()
    f = torch.from_numpy(validate_volume(img_fixed)).to(dev)
    m = torch.from_numpy(validate_volume(img_moving)).to(dev)
    if normalize:
        f, m = nnunet_norm(f), nnunet_norm(m)
    pred_f = predict_labels(predict_logits, f, patch_size, step_size, device=dev)
    pred_m = predict_labels(predict_logits, m, patch_size, step_size, device=dev)
    if num_labels is None:
        num_labels = int(torch.maximum(pred_f.max(), pred_m.max())) + 1
    out = convex_adam_semantic_torch(pred_f, pred_m, cfg, num_labels=num_labels, mult=mult,
                                     device=dev)
    return out.cpu().numpy().astype(np.float32, copy=False)
