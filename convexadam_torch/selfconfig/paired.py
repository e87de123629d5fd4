"""Paired intra-patient sweeps (MIND features, keypoint TRE metric).

Counterpart of ``convexadam_tpu/selfconfig/paired.py``.  Reference:
convex_run_paired_mind.py (stage 1) and adam_run_paired_mind_shiftSpline.py
(stage 2): lung-CT style exhale/inhale registration scored by keypoint
target registration error.  Settings and pairs are host loops on a card;
with a ``mesh`` the (setting, pair) cells spread over the ranks of a process
group as in the semantic engine (``engine.py``), and every rank returns the
same result.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from convexadam_torch.core.adam import adam_instance_optimisation
from convexadam_torch.core.features import mindssc
from convexadam_torch.core.metrics import (
    jacobian_determinant,
    keypoint_tre,
    rank_product,
    sort_rank,
)
from convexadam_torch.core.smoothing import avg_pool3d, box_smooth_repeated
from convexadam_torch.core.warp import resize_trilinear
from convexadam_torch.parallel.batch import Mesh
from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, _convex_stage
from convexadam_torch.selfconfig.engine import (
    SweepResult,
    _Fanout,
    _fill,
    _load_kernels,
    _sweep_device,
    _sync,
    convex_field_mind,
)
from convexadam_torch.selfconfig.settings import (
    STAGE2_SMOOTH_LEVELS,
    STAGE2_SNAPSHOT_ITERS,
    Stage1PairedSetting,
    Stage2Setting,
)


def _robust30_keypoints(kf: np.ndarray, km: np.ndarray) -> np.ndarray:
    """Indices of the 30% keypoints with the largest initial error
    (convex_run_paired_mind.py:90-92)."""
    tre0 = np.sqrt(((kf - km) ** 2).sum(-1))
    k = int(len(tre0) * 0.3)
    return np.argsort(-tre0)[: max(k, 1)]


def _padded_keypoints(kpts_fixed, kpts_moving, robust30, device):
    """Per-pair keypoint lists padded to one (P, n_max, 3) batch with
    validity and robust30 masks (0/1 weights: the masked means equal the
    per-pair means), on ``device``."""
    P = len(kpts_fixed)
    n_max = max(len(np.asarray(k)) for k in kpts_fixed)
    kf = np.zeros((P, n_max, 3), np.float32)
    km = np.zeros((P, n_max, 3), np.float32)
    mask = np.zeros((P, n_max), np.float32)
    rmask = np.zeros((P, n_max), np.float32)
    for i in range(P):
        a = np.asarray(kpts_fixed[i], np.float32)
        b = np.asarray(kpts_moving[i], np.float32)
        n = len(a)
        kf[i, :n], km[i, :n], mask[i, :n] = a, b, 1.0
        rmask[i, robust30[i]] = 1.0
    return tuple(torch.from_numpy(x).to(device) for x in (kf, km, mask, rmask))


def _field_metrics(disp, kf, km, mask, rmask, spacing) -> torch.Tensor:
    """(tre_mean, tre_robust30, sdlogj, neg_jac_frac) of one field
    (3, H, W, D) as one (4,) float32 tensor on its device."""
    t = keypoint_tre(disp, kf, km, spacing)
    tm = torch.sum(t * mask) / torch.clamp(torch.sum(mask), min=1.0)
    tr = torch.sum(t * rmask) / torch.clamp(torch.sum(rmask), min=1.0)
    det = jacobian_determinant(disp)
    logd = torch.log(torch.clamp(det + 3.0, 1e-9, 1e9))
    return torch.stack([tm, tr, torch.std(logd, correction=0), (det < 0).float().mean()])


def _paired_batch(imgs_fixed, imgs_moving, kpts_fixed, kpts_moving, spacing, dev):
    """Shared setup of both paired sweeps: the volumes and the padded
    keypoint batches on the device, and the spacing."""
    P = len(imgs_fixed)
    robust30 = [
        _robust30_keypoints(np.asarray(kpts_fixed[i]), np.asarray(kpts_moving[i]))
        for i in range(P)
    ]
    kpts = _padded_keypoints(kpts_fixed, kpts_moving, robust30, dev)
    imgs = [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (imgs_fixed, imgs_moving)]
    sp = None if spacing is None else torch.as_tensor(np.asarray(spacing, np.float32)).to(dev)
    return P, imgs, kpts, sp


def run_stage1_paired_sweep(
    imgs_fixed: np.ndarray,
    imgs_moving: np.ndarray,
    kpts_fixed: Sequence[np.ndarray],
    kpts_moving: Sequence[np.ndarray],
    settings: Sequence[Stage1PairedSetting],
    spacing: Optional[np.ndarray] = None,
    verbose: bool = False,
    mesh: "Mesh | None" = None,
    setting_batch: "int | None" = None,
    device: "str | torch.device | None" = None,
) -> SweepResult:
    """Stage-1 paired sweep: for each setting x pair, the convex stage on
    MIND features, scored by keypoint TRE (mean and robust30) and SDlogJ
    (convex_run_paired_mind.py:104-204); settings are rank-aggregated over
    {TRE, robust30 TRE, SDlogJ}.  ``imgs_*``: (P, H, W, D) volumes;
    ``kpts_*``: per pair (N_i, 3) voxel keypoints.  The result's ``dice``
    holds the TRE (mean, robust30) and ``hd95`` zeros.  Runs on ``cuda``
    unless ``device="cpu"``; a ``mesh`` and ``setting_batch`` spread the
    cells over ranks as in ``engine.run_stage1_sweep``."""
    dev = _sweep_device(device, mesh)
    S = len(settings)
    tre = np.zeros((S, 2))
    jstd = np.zeros((S, 2))
    times = np.zeros(S)
    P, (imgs_f, imgs_m), (kf, km, mask, rmask), sp = _paired_batch(
        imgs_fixed, imgs_moving, kpts_fixed, kpts_moving, spacing, dev
    )
    fan = _Fanout(mesh, P, setting_batch)
    mets = {"m": np.zeros((S, P, 4), np.float32)}
    _load_kernels(dev)
    for batch in fan.batches(list(range(S))):
        cells, secs = [], {}
        for s in fan.settings(batch):
            st = settings[s]
            _sync(dev)
            t0 = time.perf_counter()
            local = []
            for i in fan.pairs:
                disp = convex_field_mind(imgs_f[i], imgs_m[i], st.mind_r, st.mind_d, st.grid_sp,
                                         st.disp_hw, device=dev)
                local.append(_field_metrics(disp, kf[i], km[i], mask[i], rmask[i], sp))
            if local:  # four scalars a pair reach the host
                cells += [(s, i, m) for i, m in zip(fan.pairs, torch.stack(local).cpu().numpy())]
            secs[s] = time.perf_counter() - t0
        _fill(mets, times, fan.gather((cells, secs)), ("m",))
        for s in batch:
            tre[s] = mets["m"][s, :, :2].mean(axis=0)
            jstd[s] = mets["m"][s, :, 2:].mean(axis=0)
            if verbose and fan.lead:
                print(f"s={s} {settings[s]} TRE={tre[s, 0]:.3f}/{tre[s, 1]:.3f} "
                      f"jstd={jstd[s, 0]:.4f}")

    # rank product over {tre, tre30, jstd} (convex_run_paired_mind.py:190-199)
    rank1 = rank_product([sort_rank(tre[:, 0]), sort_rank(tre[:, 1]), sort_rank(jstd[:, 0])])
    return SweepResult(tre, jstd, np.zeros(S), times, rank1, int(rank1.argmax()))


def run_stage2_paired_sweep(
    imgs_fixed: np.ndarray,
    imgs_moving: np.ndarray,
    kpts_fixed: Sequence[np.ndarray],
    kpts_moving: Sequence[np.ndarray],
    convex_setting: Stage1PairedSetting,
    adam_settings: Sequence[Stage2Setting],
    spacing: Optional[np.ndarray] = None,
    verbose: bool = False,
    mesh: "Mesh | None" = None,
    setting_batch: "int | None" = None,
    device: "str | torch.device | None" = None,
) -> SweepResult:
    """Stage-2 paired sweep: Adam refinement with the shift-spline smoother
    bank from the convex field of ``convex_setting``, scored by TRE at
    {60, 80, 100, 120} iterations x 4 smoothing levels
    (adam_run_paired_mind_shiftSpline.py:160-296); the metric arrays come
    back flattened to (S * 16, ...).  The float32 MIND features of
    ``convex_setting`` are made once per pair (pass A; with a ``mesh``, for
    the rank's own pairs) and feed its convex field
    (:func:`convex_field_mind`'s stages) and every setting's Adam."""
    dev = _sweep_device(device, mesh)
    P, (imgs_f, imgs_m), (kf, km, mask, rmask), sp = _paired_batch(
        imgs_fixed, imgs_moving, kpts_fixed, kpts_moving, spacing, dev
    )
    fan = _Fanout(mesh, P, setting_batch)
    H, W, D = imgs_f.shape[1:]
    r, d = convex_setting.mind_r, convex_setting.mind_d
    _load_kernels(dev)
    # pass A: the MIND features and the full-resolution convex fields
    cfg = ConvexAdamConfig(grid_sp=convex_setting.grid_sp, disp_hw=convex_setting.disp_hw)
    with torch.no_grad():
        feats = {i: (mindssc(imgs_f[i], r, d), mindssc(imgs_m[i], r, d)) for i in fan.pairs}
        disps_hr0 = {i: _convex_stage(*feats[i], cfg, (H, W, D)) for i in fan.pairs}

    S = len(adam_settings)
    tre = np.zeros((S, 4, 4, 2))
    jstd = np.zeros((S, 4, 4, 2))
    times = np.zeros(S)
    mets_all = {"m": np.zeros((S, P, 4, 4, 4), np.float32)}
    for batch in fan.batches(list(range(S))):
        cells, secs = [], {}
        for s in fan.settings(batch):
            st = adam_settings[s]
            _sync(dev)
            t0 = time.perf_counter()
            g = st.grid_sp_adam
            mets = []
            for i in fan.pairs:
                with torch.no_grad():
                    pf = avg_pool3d(feats[i][0], g, stride=g)
                    pm = avg_pool3d(feats[i][1], g, stride=g)
                    dlr = resize_trilinear(disps_hr0[i], (H // g, W // g, D // g),
                                           align_corners=False)
                _, snaps = adam_instance_optimisation(
                    pf, pm, dlr / g, st.lambda_weight, niter=120,
                    snapshot_iters=STAGE2_SNAPSHOT_ITERS, smoother=("bank", st.effective_avg_n),
                    cost_scale=12.0,
                )
                with torch.no_grad():
                    for snap in snaps:
                        dhr = resize_trilinear(snap * g, (H, W, D), align_corners=False)
                        for kk in range(STAGE2_SMOOTH_LEVELS):
                            if kk > 0:
                                dhr = box_smooth_repeated(dhr, 3, 1)
                            mets.append(_field_metrics(dhr, kf[i], km[i], mask[i], rmask[i], sp))
            if mets:  # (pairs, 4 iters, 4 smooth, 4 metrics): only scalars reach the host
                m = torch.stack(mets).reshape(len(fan.pairs), 4, 4, 4).cpu().numpy()
                cells += [(s, i, m[j]) for j, i in enumerate(fan.pairs)]
            secs[s] = time.perf_counter() - t0
        _fill(mets_all, times, fan.gather((cells, secs)), ("m",))
        for s in batch:
            tre[s] = mets_all["m"][s, ..., :2].mean(axis=0)
            jstd[s] = mets_all["m"][s, ..., 2:].mean(axis=0)
            if verbose and fan.lead:
                print(f"s={s} {adam_settings[s]} best TRE={tre[s, ..., 0].min():.3f}")

    rank2 = rank_product([
        sort_rank(tre[..., 0].reshape(-1)),
        sort_rank(tre[..., 1].reshape(-1)),
        sort_rank(jstd[..., 0].reshape(-1)),
    ])
    return SweepResult(
        tre.reshape(S * 16, 2), jstd.reshape(S * 16, 2),
        np.zeros(S * 16), times, rank2, int(rank2.argmax()),
    )
