"""The Learn2Reg challenge recipes, composed from the package's entries.

Counterpart of ``convexadam_tpu/pipeline/challenges.py`` (the reference's
root scripts):

* **Task 1 (Abdomen MR-CT)**: register, densify the masked field with a
  thin-plate spline, and resample the physical displacement field back into
  the original (uncropped, unresampled) image space
  (l2r_2021_convexAdam_task1_docker.py:38-105, 283-413);
  :func:`task1_validation` runs and scores it over labelled pairs.
* **Task 2 (lung CT exhale-inhale)**: EDT lung-mask infill, one cost-volume
  box pass, no inverse consistency, Adam at grid 2, a half-resolution
  submission field (l2r_2021_convexAdam_task2_docker.py:194-332).
* **Task 3 (OASIS brain MRI)**: one-hot features weighted by frozen template
  weights, the SAD cost, double Adam smoothing, a half-resolution field
  (l2r_2021_convexAdam_task3_docker.py:109-233).
* **CuRIOUS 2020 (MRI-US)**: multichannel MIND, mask-gated cost volumes,
  coupled convex and inverse consistency, least-trimmed-squares rigid
  extraction from the deformable field, landmark TRE
  (l2r_2020_convexAdam_CuRIOUS.py:284-409).

Numpy in, numpy out, as in the JAX module; each entry runs on ``cuda``
unless given ``device="cpu"``.  The order of operations and the reference's
quirks are the JAX module's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.convex import coupled_convex
from convexadam_torch.core.cost_volume import correlate_masked, displacement_mesh
from convexadam_torch.core.features import mindssc, semantic_features
from convexadam_torch.core.rigid import rigid_from_field, thin_plate_dense
from convexadam_torch.core.smoothing import avg_pool3d, box_smooth_repeated
from convexadam_torch.core.warp import (
    grid_sample_3d,
    identity_grid_normalized,
    inverse_consistency,
    resize_trilinear,
    warp_with_displacement,
)
from convexadam_torch.pipeline.convex_adam import (
    ConvexAdamConfig,
    convex_adam,
    convex_adam_features,
    convex_adam_torch,
)
from convexadam_torch.pipeline.preprocess import mask_infill
from convexadam_torch.selfconfig.l2r import evaluate_field
from convexadam_torch.utils import trace


def _vol(x, dev, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def _half_scale(shape, dev) -> torch.Tensor:
    """((H - 1) / 2, (W - 1) / 2, (D - 1) / 2) float32."""
    return torch.tensor([(s - 1) / 2.0 for s in shape], dtype=torch.float32, device=dev)


def _voxel_grid(shape, dev) -> torch.Tensor:
    """The identity grid in voxels (H, W, D, 3), made as the JAX module makes
    it: the align_corners=True normalized grid, plus one, times (size-1)/2."""
    return (identity_grid_normalized(shape, True, device=dev) + 1.0) * _half_scale(shape, dev)


# ---------------------------------------------------------------------------
# Task 1: TPS densification + original-space resampling
# ---------------------------------------------------------------------------

TASK1_CONFIG = ConvexAdamConfig(
    mind_r=1, mind_d=2, lambda_weight=0.6, grid_sp=4, disp_hw=8,
    selected_niter=40, grid_sp_adam=3, ic=True,
)
"""Task 1's registration (l2r_2021_convexAdam_task1_docker.py:289-391):
grid_sp 4, disp_hw 8, Adam at grid 3 with 40 iterations and lambda 0.6."""


def _tps_densify(disp: np.ndarray, fixed_mask, num_samples: int, tps_step: int, smooth: bool,
                 seed: int, dev: torch.device) -> np.ndarray:
    """Task 1's densification of a registration field ``disp`` (H, W, D, 3)
    in voxels: a TPS through up to ``num_samples`` masked control points,
    evaluated on a ``tps_step`` grid, upsampled and box-smoothed."""
    H, W, D = disp.shape[:3]
    # control points: the reference builds an align_corners=True (H//3,
    # W//3, D//3) lattice -- normalized coords linspace(-1, 1, n) per axis,
    # i.e. voxels i*(H-1)/(H//3-1), STRETCHED across the full extent, not
    # the 3i+1 grid -- masks it with fixed_mask[1::3,1::3,1::3] (cropped to
    # the lattice shape; a deliberate reference quirk: the mask is read at
    # 3i+1 while the point sits at the stretched position), randperms 4096,
    # and grid_samples the dense field there with align_corners=False
    # (task1_docker.py:365-374).  Only the permutation RNG differs (seeded
    # here; torch.randperm was unseeded).
    n3 = (H // 3, W // 3, D // 3)
    mask3 = (
        np.asarray(fixed_mask, np.float32)[1::3, 1::3, 1::3][: n3[0], : n3[1], : n3[2]] > 0
    )
    axes = [np.linspace(-1.0, 1.0, n, dtype=np.float32) for n in n3]
    lattice = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    pts_norm = lattice[mask3.reshape(-1)]
    rng = np.random.default_rng(seed)
    pts_norm = pts_norm[rng.permutation(len(pts_norm))[:num_samples]]
    trace.count("tps.control_points", len(pts_norm))

    with torch.no_grad():
        field = torch.from_numpy(np.ascontiguousarray(disp)).to(dev).permute(3, 0, 1, 2)
        x1 = torch.from_numpy(np.ascontiguousarray(pts_norm)).to(dev)
        # the field at the (non-integer) control positions: trilinear, the
        # reference's default align_corners=False
        vals = grid_sample_3d(field, x1.reshape(-1, 1, 1, 3), align_corners=False)
        scale = _half_scale((H, W, D), dev)
        y1 = vals.reshape(3, -1).T / scale
        dense = thin_plate_dense(x1, y1, (H, W, D), tps_step, 0.0)  # (H, W, D, 3) normalized
        dense_vox = dense.permute(3, 0, 1, 2) * scale.reshape(3, 1, 1, 1)
        if smooth:
            with trace.span("tps.smooth"):
                dense_vox = box_smooth_repeated(dense_vox, 3, 3)
        return dense_vox.permute(1, 2, 3, 0).cpu().numpy().astype(np.float32, copy=False)


def register_tps_densified(
    img_fixed: np.ndarray,
    img_moving: np.ndarray,
    fixed_mask: np.ndarray,
    num_samples: int = 4096,
    tps_step: int = 4,
    smooth: bool = True,
    cfg: "ConvexAdamConfig | None" = None,
    seed: int = 0,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Task 1's registration: :func:`convex_adam` with :data:`TASK1_CONFIG`
    (or ``cfg``), then a thin-plate spline through up to ``num_samples``
    control points of the field inside ``fixed_mask``, evaluated on a
    ``tps_step`` grid, upsampled, and (``smooth``) triple-box-smoothed
    (l2r_2021_convexAdam_task1_docker.py:289-391).  Returns (H, W, D, 3)
    float32 voxels."""
    dev = _resolve_device(device)
    with trace.span("task1.register"):
        disp = convex_adam(img_fixed, img_moving, cfg or TASK1_CONFIG, device=dev)
    with trace.span("task1.densify"):
        return _tps_densify(disp, fixed_mask, num_samples, tps_step, smooth, seed, dev)


@dataclasses.dataclass(frozen=True)
class Task1CaseMeta:
    """Per-case preprocessing metadata (the reference's ``cases.csv`` row,
    l2r_2021_convexAdam_task1_docker.py:39-50): original shapes and
    spacings, and the crop boxes that produced the preprocessed volumes."""

    fix_shape: "tuple[int, int, int]"
    fix_spacing: "tuple[float, float, float]"
    fix_crop: "tuple[tuple[float, float, float], tuple[float, float, float]]"  # (lo, hi)
    mov_shape: "tuple[int, int, int]"
    mov_spacing: "tuple[float, float, float]"
    mov_crop: "tuple[tuple[float, float, float], tuple[float, float, float]]"
    ref_spacing: "tuple[float, float, float]" = (2.0, 2.0, 2.0)
    flip: str = "xy"


def task1_field_to_original(
    disp_vox: np.ndarray,
    fix_spacing_pre: np.ndarray,
    mov_spacing_pre: np.ndarray,
    meta: Task1CaseMeta,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """A voxel displacement field (H, W, D, 3) in the preprocessed (cropped
    and resampled) space → the half-resolution field over the ORIGINAL fixed
    image grid (l2r_2021_convexAdam_task1_docker.py:38-105, :393-400):

      1. physical displacement in the preprocessed space,
         ``(x + disp[x]) * mov_spacing_pre - x * fix_spacing_pre``;
      2. for every voxel of the original fixed grid, mapped through the
         crop and scale into preprocessed-fixed coordinates, that
         displacement sampled there (border padding, align_corners=True);
      3. the physical moving position → preprocessed moving coordinates →
         original moving voxels through the moving crop and scale;
      4. voxel displacement = estimate - identity; the flipped axes
         reversed and negated;
      5. a trilinear x0.5 resize.

    Returns (3, H0 / 2, W0 / 2, D0 / 2) float32 (the submission payload).
    """
    dev = _resolve_device(device)
    H, W, D = disp_vox.shape[:3]
    with torch.no_grad():
        fix_sp = _vol(fix_spacing_pre, dev)
        mov_sp = _vol(mov_spacing_pre, dev)
        grid_vox = _voxel_grid((H, W, D), dev)
        disp_p = (grid_vox + _vol(disp_vox, dev)) * mov_sp - grid_vox * fix_sp
        disp_p = disp_p.permute(3, 0, 1, 2).contiguous()  # (3, H, W, D) physical units

        fix_spacing = np.asarray(meta.fix_spacing, np.float32)
        fix_crop = np.asarray(meta.fix_crop, np.float32)  # (2, 3)
        mov_spacing = np.asarray(meta.mov_spacing, np.float32)
        mov_crop = np.asarray(meta.mov_crop, np.float32)
        ref_spacing = np.asarray(meta.ref_spacing, np.float32)

        new_shape = np.round((fix_crop[1] - fix_crop[0]) * fix_spacing / ref_spacing)
        new_fix_scale = new_shape / (fix_crop[1] - fix_crop[0])
        new_fix_spacing = fix_spacing / new_fix_scale
        new_mov_scale = new_shape / (mov_crop[1] - mov_crop[0])
        new_mov_spacing = mov_spacing / new_mov_scale

        H0, W0, D0 = (int(s) for s in meta.fix_shape)
        orig_grid = _voxel_grid((H0, W0, D0), dev)  # original voxel coordinates

        # original fixed voxel → preprocessed-fixed coordinates (the inverse
        # of fix_affine: x_pre = (x_orig - crop_lo) * new_fix_scale)
        pre_coords = (orig_grid - _vol(fix_crop[0], dev)) * _vol(new_fix_scale, dev)
        # normalized (align_corners=True) over the preprocessed grid
        pre_norm = pre_coords / _half_scale((H, W, D), dev) - 1.0
        disp_p_s = grid_sample_3d(disp_p, pre_norm, align_corners=True, padding_mode="border")
        disp_p_s = disp_p_s.permute(1, 2, 3, 0)

        mov_pre_est = (pre_coords * _vol(new_fix_spacing, dev) + disp_p_s) / _vol(
            new_mov_spacing, dev)
        # preprocessed moving coordinates → original moving voxels (mov_affine:
        # x_orig = x_pre / new_mov_scale + mov_crop_lo)
        mov_orig_est = mov_pre_est / _vol(new_mov_scale, dev) + _vol(mov_crop[0], dev)
        disp_out = mov_orig_est - orig_grid  # (H0, W0, D0, 3) voxels

        for ax, name in enumerate("xyz"):
            if name in meta.flip:
                disp_out = torch.flip(disp_out, dims=(ax,))
                disp_out[..., ax] *= -1.0

        disp_out = disp_out.permute(3, 0, 1, 2)
        half = (H0 // 2, W0 // 2, D0 // 2)
        disp_half = resize_trilinear(disp_out, half, align_corners=False)
        return disp_half.cpu().numpy().astype(np.float32, copy=False)


@dataclasses.dataclass
class Task1Validation:
    """What :func:`task1_validation` returns: per pair the scores of
    :func:`~convexadam_torch.selfconfig.l2r.evaluate_field` (``dice``,
    ``dice30``, ``hd95``, ``sdlogj``, ``neg_jac_frac``), the
    half-resolution original-space field (3, H0 / 2, W0 / 2, D0 / 2), the
    densified field (H, W, D, 3) that was scored and mapped (kept so that
    a caller can rescore or remap it with another implementation), and the
    call's record (``utils/trace.py``): its spans and counters, empty
    unless a profiler recorded."""

    scores: list
    fields: list
    densified: list
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


def task1_validation(
    imgs_fixed,
    imgs_moving,
    fixed_masks,
    segs_fixed,
    segs_moving,
    metas: "list[Task1CaseMeta]",
    num_labels: int,
    cfg: "ConvexAdamConfig | None" = None,
    device: "str | torch.device | None" = None,
) -> Task1Validation:
    """Task 1 over its labelled pairs, as a participant validates the
    recipe: for pair ``i`` (row ``i`` of each stack (P, H, W, D), the
    volumes preprocessed to ``metas[i].ref_spacing``),
    :func:`register_tps_densified` (``cfg``, the recipe's spline), the
    densified field mapped to the original fixed grid of ``metas[i]`` by
    :func:`task1_field_to_original`, and the densified field scored against
    the pair's labels 1..``num_labels`` by
    :func:`~convexadam_torch.selfconfig.l2r.evaluate_field`.  The fields
    are those of the three functions called alone.  Runs on ``cuda`` unless
    ``device="cpu"``."""
    dev = _resolve_device(device)
    scores, fields, densified = [], [], []
    with trace.recording() as rec:
        trace.on_device(dev)
        for i, meta in enumerate(metas):
            with trace.span("task1.pair", (None, i)):
                dense = register_tps_densified(imgs_fixed[i], imgs_moving[i], fixed_masks[i],
                                               cfg=cfg, device=dev)
                sp = np.asarray(meta.ref_spacing, np.float32)
                with trace.span("task1.original"):
                    fields.append(task1_field_to_original(dense, sp, sp, meta, device=dev))
                with trace.span("task1.evaluate"):
                    scores.append(evaluate_field(dense, segs_fixed[i], segs_moving[i],
                                                 num_labels, device=dev))
                densified.append(dense)
    return Task1Validation(scores, fields, densified, rec.spans, rec.counters)


# ---------------------------------------------------------------------------
# Task 2: lung CT exhale-inhale
# ---------------------------------------------------------------------------

TASK2_CONFIG = ConvexAdamConfig(
    mind_r=1, mind_d=2, lambda_weight=0.65, grid_sp=4, disp_hw=6,
    selected_niter=50, selected_smooth=3, grid_sp_adam=2, ic=False,
    cost_smooth_passes=1,
)
"""The lung-CT recipe (l2r_2021_convexAdam_task2_docker.py): grid_sp 4,
disp_hw 6 (:210-211), ONE cost-volume box pass (:60), no inverse
consistency (:245-248 commented out), Adam at grid 2 with 50 iterations and
lambda 0.65 (:276-278), triple 3^3 post-smoothing (:302)."""


def task2_case(
    img_fixed: np.ndarray,
    img_moving: np.ndarray,
    fixed_mask: np.ndarray,
    moving_mask: np.ndarray,
    cfg: ConvexAdamConfig = TASK2_CONFIG,
    device: "str | torch.device | None" = None,
) -> dict:
    """One lung-CT case (l2r_2021_convexAdam_task2_docker.py:194-332): the
    nearest-inside EDT infill of both volumes outside their lung masks
    (:215-226, the packaged ``use_mask`` path's), the :data:`TASK2_CONFIG`
    registration and the half-resolution submission field (:305).

    Returns {"disp": (H, W, D, 3) voxels, "disp_half": (3, H/2, W/2, D/2)}.
    """
    dev = _resolve_device(device)
    fixed_r = mask_infill(np.asarray(img_fixed, np.float32), np.asarray(fixed_mask, np.float32),
                          device=dev)
    moving_r = mask_infill(np.asarray(img_moving, np.float32),
                           np.asarray(moving_mask, np.float32), device=dev)
    disp = convex_adam_torch(torch.from_numpy(fixed_r).to(dev),
                             torch.from_numpy(moving_r).to(dev), cfg)  # (H, W, D, 3)
    H, W, D = fixed_r.shape
    with torch.no_grad():
        disp_half = resize_trilinear(disp.permute(3, 0, 1, 2), (H // 2, W // 2, D // 2),
                                     align_corners=False)
    return {
        "disp": disp.cpu().numpy().astype(np.float32, copy=False),
        "disp_half": disp_half.cpu().numpy().astype(np.float32, copy=False),
    }


# ---------------------------------------------------------------------------
# Task 3: OASIS brain MRI (semantic features, SAD cost)
# ---------------------------------------------------------------------------

TASK3_CONFIG = ConvexAdamConfig(
    lambda_weight=1.25, grid_sp=2, disp_hw=3, selected_niter=100,
    selected_smooth=0, grid_sp_adam=2, ic=False,
    cost_metric="sad", cost_smooth_passes=1, adam_smoother=("box", 3, 2),
)
"""The OASIS recipe (l2r_2021_convexAdam_task3_docker.py): grid_sp 2,
disp_hw 3 (:109-110), the SAD cost with one box pass (:54, :47), no inverse
consistency, Adam with 100 iterations, lambda 1.25 and DOUBLE (not triple)
3^3 smoothing (:186-191)."""


def task3_case(
    seg_fixed: np.ndarray,
    seg_moving: np.ndarray,
    num_labels: int,
    template_weights: "np.ndarray | None" = None,
    cfg: ConvexAdamConfig = TASK3_CONFIG,
    device: "str | torch.device | None" = None,
) -> dict:
    """One OASIS inter-subject case (l2r_2021_convexAdam_task3_docker.py:109-233):
    weighted one-hot features of the predicted segmentations, with the
    script's frozen template weights where given (:118-120; see
    :func:`~convexadam_torch.core.features.semantic_template_weights`), else
    per-pair weights, then the :data:`TASK3_CONFIG` registration and the
    half-resolution submission field (:216).

    Returns {"disp": (H, W, D, 3) voxels, "disp_half": (3, H/2, W/2, D/2)}.
    """
    dev = _resolve_device(device)
    sf = torch.as_tensor(np.asarray(seg_fixed)).to(dev)
    sm = torch.as_tensor(np.asarray(seg_moving)).to(dev)
    H, W, D = sf.shape
    weights = None if template_weights is None else _vol(template_weights, dev)
    with torch.no_grad():
        ff, fm = semantic_features(sf, sm, num_labels=num_labels, mult=10.0,
                                   dtype=cfg.compute_dtype(dev), weights=weights)
    disp = convex_adam_features(ff, fm, cfg)  # (H, W, D, 3)
    with torch.no_grad():
        disp_half = resize_trilinear(disp.permute(3, 0, 1, 2), (H // 2, W // 2, D // 2),
                                     align_corners=False)
    return {
        "disp": disp.cpu().numpy().astype(np.float32, copy=False),
        "disp_half": disp_half.cpu().numpy().astype(np.float32, copy=False),
    }


# ---------------------------------------------------------------------------
# CuRIOUS 2020: MRI-US with rigid extraction + landmark TRE
# ---------------------------------------------------------------------------

def landmark_centroids(seg: np.ndarray, num_landmarks: int) -> np.ndarray:
    """Mean voxel coordinate of each landmark label 1..num_landmarks
    (l2r_2020_convexAdam_CuRIOUS.py:312-317); a missing label gives a NaN
    row."""
    out = np.full((num_landmarks, 3), np.nan, np.float32)
    for i in range(1, num_landmarks + 1):
        pos = np.nonzero(seg == i)
        if len(pos[0]):
            out[i - 1] = [p.mean() for p in pos]
    return out


def _tre(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.sqrt(((a - b) ** 2).sum(-1))


def curious_case(
    img_fixed_us: np.ndarray,
    img_moving_t1: np.ndarray,
    img_moving_flair: np.ndarray,
    seg_fixed: np.ndarray,
    seg_moving: np.ndarray,
    grid_sp: int = 6,
    disp_hw: int = 6,
    mind_r: int = 3,
    mind_d: int = 3,
    mask_threshold: float = 10.0,
    ic_iters: int = 5,
    rigid_samples: int = 4096,
    device: "str | torch.device | None" = None,
) -> dict:
    """One CuRIOUS MRI-US case (l2r_2020_convexAdam_CuRIOUS.py:284-409):

      1. MIND (r 3, d 3) of the US (twice, 24 channels) against T1 and FLAIR
         concatenated (:323-327);
      2. mask-gated cost volumes (``ssd *= mask``, :336, :349) in both
         directions, coupled convex and inverse consistency (5 steps);
      3. a least-trimmed-squares rigid transform from the masked deformable
         field (:359-371; fitted in voxel space, a true rigid of the
         isotropically sampled array, where the reference fits in torch's
         normalized coordinates);
      4. the landmark TRE of identity, deformable and rigid (landmarks are
         label balls; the distance between label centroids).

    Returns {"tre0", "tre_def", "tre_rigid" (per-landmark voxel TREs),
    "disp" (H, W, D, 3), "rigid" (4 x 4)}.
    """
    dev = _resolve_device(device)
    H, W, D = np.asarray(img_fixed_us).shape
    us = _vol(img_fixed_us, dev)
    t1 = _vol(img_moving_t1, dev)
    fl = _vol(img_moving_flair, dev)
    g = grid_sp

    with torch.no_grad():
        mf = mindssc(us, mind_r, mind_d)
        mt1 = mindssc(t1, mind_r, mind_d)
        mfl = mindssc(fl, mind_r, mind_d)
        fix_feat = torch.cat([avg_pool3d(mf, g, stride=g)] * 2, dim=0)
        mov_feat = torch.cat([avg_pool3d(mt1, g, stride=g), avg_pool3d(mfl, g, stride=g)], dim=0)
        del mf, mt1, mfl
        mask_fix = avg_pool3d((us > mask_threshold).float()[None], g, stride=g)[0] > 0.5
        mask_mov = avg_pool3d((t1 > mask_threshold).float()[None], g, stride=g)[0] > 0.5

        mesh = displacement_mesh(disp_hw, device=dev)
        ssd, am = correlate_masked(fix_feat, mov_feat, mask_fix, disp_hw)
        disp_soft = coupled_convex(ssd, am, mesh)
        del ssd
        ssd_r, am_r = correlate_masked(mov_feat, fix_feat, mask_mov, disp_hw)
        disp_soft_r = coupled_convex(ssd_r, am_r, mesh)
        del ssd_r
        h, w, d = disp_soft.shape[1:]
        scale = _half_scale((h, w, d), dev).reshape(3, 1, 1, 1)
        disp_ice, _ = inverse_consistency(disp_soft / scale, disp_soft_r / scale, ic_iters)
        disp_hr = resize_trilinear(disp_ice * scale * g, (H, W, D), align_corners=False)

        # rigid from the masked field (least-trimmed squares)
        mask_hr = resize_trilinear(mask_fix[None].float(), (H, W, D), align_corners=False)[0] > 0.5
        R = rigid_from_field(disp_hr, mask=mask_hr, num_samples=rigid_samples, iters=15)

        # landmark TREs
        num_landmarks = int(np.asarray(seg_moving).max())
        c_fix = landmark_centroids(np.asarray(seg_fixed), num_landmarks)
        c_mov = landmark_centroids(np.asarray(seg_moving), num_landmarks)

        seg_m = _vol(seg_moving, dev)[None]
        warped_def = warp_with_displacement(seg_m, disp_hr, mode="nearest")[0]
        c_def = landmark_centroids(warped_def.round().int().cpu().numpy(), num_landmarks)

        # rigid warp: the moving labels sampled at R-transformed positions
        grid_vox = _voxel_grid((H, W, D), dev)
        pts = grid_vox.reshape(-1, 3)
        pts_h = torch.cat([pts, torch.ones((pts.shape[0], 1), dtype=torch.float32, device=dev)],
                          dim=1)
        moved = (pts_h @ R.T)[:, :3].reshape(H, W, D, 3)
        disp_rigid = (moved - grid_vox).permute(3, 0, 1, 2)
        del pts_h, moved
        warped_rigid = warp_with_displacement(seg_m, disp_rigid, mode="nearest")[0]
        c_rigid = landmark_centroids(warped_rigid.round().int().cpu().numpy(), num_landmarks)

        return {
            "tre0": _tre(c_fix, c_mov),
            "tre_def": _tre(c_fix, c_def),
            "tre_rigid": _tre(c_fix, c_rigid),
            "disp": disp_hr.permute(1, 2, 3, 0).cpu().numpy().astype(np.float32, copy=False),
            "rigid": R.cpu().numpy().astype(np.float32, copy=False),
        }
