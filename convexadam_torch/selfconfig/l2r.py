"""Learn2Reg task driver: dataset-descriptor-driven grid ablation, official
statistical ranking and test-set submission, with a built-in evaluator.

Counterpart of ``convexadam_tpu/selfconfig/l2r.py``; reference:
self_configuring/l2r3.py (orchestrator) + main_for_l2r3_{MIND,nnUNet}[_testset].py
(runners).  The reference delegates its metrics to the external L2R
evaluation repository; like the JAX package, the port computes Dice,
Dice30, HD95, SDlogJ, the negative-Jacobian fraction and keypoint TRE
itself (:func:`evaluate_field`).

Cases are read from disk through :mod:`convexadam_torch.geometry.io`
(masks as infill, :func:`convexadam_torch.pipeline.preprocess.mask_infill`);
features, registration and evaluation run on ``cuda`` unless the caller
passes ``device="cpu"``.  The fields stay on the device until they are
evaluated; only the file write fetches them.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.edt import MAX_PACKED_EXTENT, hd95_device_sized
from convexadam_torch.core.features import mindssc, semantic_features
from convexadam_torch.core.metrics import (
    dice_coeff,
    hd95,
    jacobian_determinant,
    keypoint_tre,
)
from convexadam_torch.core.warp import warp_with_displacement
from convexadam_torch.geometry.io import load_volume_nib_order, save_volume_nib_order
from convexadam_torch.pipeline.convex_adam import (
    ConvexAdamConfig,
    convex_adam_features,
    convex_adam_multi_output,
)
from convexadam_torch.pipeline.preprocess import mask_infill
from convexadam_torch.selfconfig.rank import aggregate_ranks, noisy_metric_rank
from convexadam_torch.utils import trace


def _on(x, device: torch.device, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def evaluate_field(
    disp,
    seg_fixed=None,
    seg_moving=None,
    num_labels: int = 0,
    kpts_fixed=None,
    kpts_moving=None,
    spacing: Optional[np.ndarray] = None,
    compute_hd95: bool = True,
    device: "str | torch.device | None" = None,
) -> dict:
    """Official-style metrics of a displacement field (H, W, D, 3) in voxels.

    Inputs are numpy arrays or tensors; the work runs on ``cuda`` unless
    ``device="cpu"``.  Returns ``sdlogj``, ``neg_jac_frac`` and, with labels,
    ``dice`` (per label), ``dice30`` (mean of the worst 30%) and ``hd95``
    (per label), with keypoints ``tre`` (per keypoint) and ``tre30`` (mean of
    the worst 30%); arrays come back as numpy.

    HD95 runs on the device engine (:func:`hd95_device_sized`) whenever every
    axis is at most :data:`MAX_PACKED_EXTENT`.  Beyond it the engine's exact
    FP32 distances do not hold: on the card that raises, before any work;
    with ``device="cpu"`` the host scipy EDT loop scores HD95, as the JAX
    package does off the TPU.  (The JAX package takes the engine only on a
    TPU backend; both give the same numbers.)
    """
    dev = _resolve_device(device)
    beyond = (
        compute_hd95 and seg_fixed is not None and num_labels > 0
        and max(seg_fixed.shape) > MAX_PACKED_EXTENT
    )
    if beyond and dev.type != "cpu":
        raise ValueError(
            f"HD95 on {dev} supports extents <= {MAX_PACKED_EXTENT} per axis "
            f"(got {tuple(seg_fixed.shape)}); pass compute_hd95=False or device='cpu'"
        )
    out: dict = {}
    # the ranges cost nothing without a profiler; they let
    # scripts/profile_torch_evaluation.py split this entry's time by stage
    with trace.span("evaluate_field.jacobian"):
        d = _on(disp, dev, torch.float32).permute(3, 0, 1, 2).contiguous()
        det = jacobian_determinant(d)
        logj = torch.log(torch.clamp(det + 3.0, 1e-9, 1e9))
        out["sdlogj"] = float(torch.std(logj.double(), correction=0))
        out["neg_jac_frac"] = float((det < 0).double().mean())
    if seg_fixed is not None and num_labels > 0:
        with trace.span("evaluate_field.warp_dice"):
            seg_f = _on(seg_fixed, dev)
            warped = warp_with_displacement(
                _on(seg_moving, dev, torch.float32)[None], d, mode="nearest"
            )[0].round().to(torch.int32)
            dice = dice_coeff(seg_f, warped, num_labels + 1).cpu().numpy()
        out["dice"] = dice
        k = max(1, int((num_labels + 1) * 0.3))
        out["dice30"] = float(np.sort(dice)[:k].mean())
        if compute_hd95:
            with trace.span("evaluate_field.hd95"):
                if beyond:
                    out["hd95"] = hd95(seg_f.numpy(), warped.numpy(), num_labels)
                else:
                    out["hd95"] = hd95_device_sized(
                        seg_f, warped, num_labels, device=dev
                    ).cpu().numpy()
    if kpts_fixed is not None:
        with trace.span("evaluate_field.tre"):
            tre = keypoint_tre(
                d,
                _on(kpts_fixed, dev, torch.float32),
                _on(kpts_moving, dev, torch.float32),
                None if spacing is None else _on(spacing, dev, torch.float32),
            ).cpu().numpy()
        out["tre"] = tre
        k = max(1, int(len(tre) * 0.3))
        out["tre30"] = float(np.sort(tre)[-k:].mean())
    return out


# ---------------------------------------------------------------------------
# the task driver
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class L2RTask:
    """A Learn2Reg-style task directory with ``<task>_dataset.json``
    (l2r3.py:75-103, main_for_l2r3_MIND.py:27-44)."""

    task_dir: Path
    name: str
    modality_fixed: str = ""
    modality_moving: str = ""
    semantic_features: bool = False
    use_mask: bool = False
    # "voxel" (array-index rows, the L2R CSV default) or "world" (mm rows in
    # the image's physical space, converted through the inverse affine at
    # load time)
    keypoint_space: str = "voxel"
    expected_shape: "tuple[int, int, int]" = (0, 0, 0)
    # task-level label count (dataset.json "labels"); 0 derives it per case.
    # A task-level count keeps per-case metric vectors the same length even
    # when a case lacks the top label id.
    num_labels: int = 0
    registration_val: list = dataclasses.field(default_factory=list)
    registration_test: list = dataclasses.field(default_factory=list)
    evaluation_methods: list = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, data_dir, task_name: str) -> "L2RTask":
        task_dir = Path(data_dir) / task_name
        with open(task_dir / f"{task_name}_dataset.json") as f:
            data = json.load(f)
        mods = data.get("modality", {"0": ""})
        modality_fixed = mods.get("0", "")
        modality_moving = mods.get("1", modality_fixed)
        provided = data.get("provided_data", {})
        semantic = any("label" in v for v in provided.values())
        masks = any("mask" in v for v in provided.values())
        kp_space = str(data.get("keypoint_space", "voxel")).lower()
        if kp_space not in ("voxel", "world"):
            raise ValueError(f"keypoint_space must be 'voxel' or 'world', got {kp_space!r}")

        eval_cfg = task_dir / f"{task_name}_VAL_evaluation_config.json"
        methods = []
        expected_shape = (0, 0, 0)
        if eval_cfg.exists():
            with open(eval_cfg) as f:
                ec = json.load(f)
            methods = ec.get("evaluation_methods", [])
            expected_shape = tuple(ec.get("expected_shape", (0, 0, 0)))
        # task-level label count: explicit "num_labels", or the max id in a
        # dataset.json "labels" table ({"1": "spleen", ...})
        num_labels = int(data.get("num_labels", 0))
        if not num_labels and isinstance(data.get("labels"), dict):
            ids = [int(k) for k in data["labels"].keys() if str(k).lstrip("-").isdigit()]
            num_labels = max(ids) if ids else 0
        return cls(
            task_dir=task_dir,
            name=task_name,
            modality_fixed=modality_fixed,
            modality_moving=modality_moving,
            semantic_features=semantic,
            use_mask=masks,
            keypoint_space=kp_space,
            expected_shape=expected_shape,
            registration_val=data.get("registration_val", []),
            registration_test=data.get("registration_test", []),
            evaluation_methods=methods,
            num_labels=num_labels,
        )

    # heuristics from l2r3.py:54-71,97-103
    @property
    def grid_options(self) -> "tuple[list[int], list[int], list[float]]":
        vol = int(np.prod(self.expected_shape)) if all(self.expected_shape) else 0
        if vol > 1_000_000:
            grid_sps, disp_hws = [6], [6, 4]
        else:
            grid_sps, disp_hws = [4], [4, 2]
        return grid_sps, disp_hws, [0.75, 1.0, 1.25]

    @property
    def mind_params(self) -> "tuple[int, int]":
        if "US" in self.modality_fixed or "US" in self.modality_moving:
            return 3, 3
        return 1, 2


def _load_case(task: L2RTask, pair: dict, device=None) -> dict:
    """Load one registration case from disk: images and affine, optional
    keypoints, masks (applied as infill on ``device``), ground-truth labels,
    and predicted labels (the nnU-Net arm's inputs,
    main_for_l2r3_nnUNet.py:76-80: ``images → predictedlabels``, falling
    back to the ground truth when there are no predictions).  Arrays are
    numpy, as the JAX package's."""
    fixed, affine = load_volume_nib_order(task.task_dir / pair["fixed"])
    moving, affine_mov = load_volume_nib_order(task.task_dir / pair["moving"])
    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)

    kf = km = None
    kf_path = task.task_dir / pair["fixed"].replace("images", "keypoints").replace(".nii.gz", ".csv")
    km_path = task.task_dir / pair["moving"].replace("images", "keypoints").replace(".nii.gz", ".csv")
    if kf_path.exists() and km_path.exists():
        kf = np.loadtxt(kf_path, delimiter=",").reshape(-1, 3)
        km = np.loadtxt(km_path, delimiter=",").reshape(-1, 3)
        if task.keypoint_space == "world":
            # mm rows → voxel indices through each image's own inverse affine
            inv = np.linalg.inv(affine)
            inv_m = np.linalg.inv(affine_mov)
            kf = kf @ inv[:3, :3].T + inv[:3, 3]
            km = km @ inv_m[:3, :3].T + inv_m[:3, 3]

    # per-axis voxel size from the affine columns: the official evaluator
    # reports TRE in mm
    spacing = np.linalg.norm(affine[:3, :3], axis=0).astype(np.float32)

    if task.use_mask:
        mf, _ = load_volume_nib_order(task.task_dir / pair["fixed"].replace("images", "masks"))
        mm, _ = load_volume_nib_order(task.task_dir / pair["moving"].replace("images", "masks"))
        fixed = mask_infill(fixed, np.asarray(mf, np.float32), device=device)
        moving = mask_infill(moving, np.asarray(mm, np.float32), device=device)

    seg_f = seg_m = None
    num_labels = 0
    lf = task.task_dir / pair["fixed"].replace("images", "labels")
    lm = task.task_dir / pair["moving"].replace("images", "labels")
    if lf.exists() and lm.exists():
        seg_f = np.asarray(load_volume_nib_order(lf)[0], np.int32)
        seg_m = np.asarray(load_volume_nib_order(lm)[0], np.int32)
        num_labels = task.num_labels or int(max(seg_f.max(), seg_m.max()))

    pred_f = pred_m = None
    pf_path = task.task_dir / pair["fixed"].replace("images", "predictedlabels")
    pm_path = task.task_dir / pair["moving"].replace("images", "predictedlabels")
    if pf_path.exists() and pm_path.exists():
        pred_f = np.asarray(load_volume_nib_order(pf_path)[0], np.int32)
        pred_m = np.asarray(load_volume_nib_order(pm_path)[0], np.int32)
    elif seg_f is not None:
        pred_f, pred_m = seg_f, seg_m

    return dict(
        fixed=fixed, moving=moving, affine=affine, spacing=spacing,
        kf=kf, km=km, seg_f=seg_f, seg_m=seg_m, num_labels=num_labels,
        pred_f=pred_f, pred_m=pred_m,
    )


def _arm_features(arm: str, case: dict, mind_r: int, mind_d: int, dtype, device):
    """Features on ``device`` for one grid-ablation arm: MIND-SSC
    descriptors, or weighted one-hot semantic features of the predicted
    labels (main_for_l2r3_nnUNet.py:91-100 → convex_adam_nnUNet.py:19-38)."""
    with torch.no_grad():
        if arm == "MIND":
            return tuple(
                mindssc(_on(case[k], device, torch.float32), mind_r, mind_d, dtype=dtype)
                for k in ("fixed", "moving")
            )
        if case["pred_f"] is None:
            raise FileNotFoundError(
                "nnUNet arm needs predicted labels (predictedlabels dir) or GT "
                "labels for this pair"
            )
        nl = int(max(case["pred_f"].max(), case["pred_m"].max())) + 1
        return semantic_features(
            _on(case["pred_f"], device), _on(case["pred_m"], device),
            num_labels=nl, mult=10.0, dtype=dtype,
        )


def _case_name(pair: dict) -> str:
    """``<fixed stem>_<moving stem>``: pairs may share a fixed image."""
    return f"{Path(pair['fixed']).name.split('.')[0]}_{Path(pair['moving']).name.split('.')[0]}"


def _grid_case(task, pair, arm, cfg, iters, smoothings, key0, per_variant, output_dir, dev):
    """One validation case of one (setting, arm): register once, then
    evaluate and write each of the ``iters`` x ``smoothings`` variants into
    ``per_variant``.  Returns the host seconds of each step."""
    mind_r, mind_d = task.mind_params
    _sync(dev)
    t0 = time.perf_counter()
    case = _load_case(task, pair, device=dev)
    t1 = time.perf_counter()
    ff, fm = _arm_features(arm, case, mind_r, mind_d, cfg.compute_dtype(dev), dev)
    fields = convex_adam_multi_output(ff, fm, cfg, iters, smoothings, device=dev)
    del ff, fm
    _sync(dev)
    t2 = time.perf_counter()
    seg_f = None if case["seg_f"] is None else _on(case["seg_f"], dev)
    seg_m = None if case["seg_m"] is None else _on(case["seg_m"], dev)
    t_eval = t_write = 0.0
    for a, it in enumerate(iters):
        for b, sm in enumerate(smoothings):
            vkey = f"{key0};{it};{sm}"
            t3 = time.perf_counter()
            m = evaluate_field(
                fields[a, b], seg_f, seg_m, case["num_labels"],
                kpts_fixed=case["kf"], kpts_moving=case["km"],
                spacing=case["spacing"], device=dev,
            )
            t4 = time.perf_counter()
            r = per_variant[vkey]
            if "dice" in m:
                r["dice"].append(m["dice"])
                r["dice30"].append(m["dice30"])
                r["hd95"].append(m["hd95"])
            if "tre" in m:
                r["tre"].append(m["tre"])
                r["tre30"].append(m["tre30"])
            r["sdlogj"].append(m["sdlogj"])
            r["time"].append(t2 - t0)
            # persist the field like the reference runners, named by both
            # stems, as run_testset does; only this write fetches the field
            save_volume_nib_order(
                fields[a, b].cpu().numpy(), case["affine"],
                output_dir / f"disp_{vkey.replace(';', '_')}_{_case_name(pair)}.nii.gz",
            )
            t_eval += t4 - t3
            t_write += time.perf_counter() - t4
    return {"load": t1 - t0, "register": t2 - t1, "evaluate": t_eval, "write": t_write}


def run_validation_grid(
    task: L2RTask,
    output_dir,
    iters: "tuple[int, ...]" = (40, 60, 80),
    smoothings: "tuple[int, ...]" = (0, 3, 5),
    dtype: str = "float32",
    verbose: bool = True,
    grid_override: "Optional[tuple[list, list, list]]" = None,
    device: "str | torch.device | None" = None,
    timings: "Optional[list]" = None,
) -> dict:
    """The l2r3 grid ablation over the validation pairs: for every
    (grid_sp, disp_hw, lambda) x {MIND, nnUNet} x 9 output variants, save
    the fields and collect per-case metrics (l2r3.py:106-221 +
    main_for_l2r3_{MIND,nnUNet}.py).  Runs on ``cuda`` unless
    ``device="cpu"``.

    The nnUNet arm runs when the task provides labels (l2r3.py:166),
    registering weighted one-hot features of the predicted segmentations
    (``predictedlabels`` dir, falling back to the ground truth); masks are
    not used in that arm's features (l2r3.py:165 forces use_mask=False).

    Returns {variant_key: {"dice": (cases, L), "sdlogj": (cases,), ...,
    "median_case_time": float}}; a case's time is its load and registration,
    read after the device has finished.  With a list as ``timings``, one
    dict per (setting, arm, case) is appended to it: the host seconds of
    ``load`` (masks infilled), ``register`` (features and the multi-output
    run, synchronized), ``evaluate`` (every variant) and ``write`` (every
    variant's fetch and file).
    """
    dev = _resolve_device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    mind_r, mind_d = task.mind_params
    grid_sps, disp_hws, lambdas = grid_override or task.grid_options
    arms = ["MIND"] + (["nnUNet"] if task.semantic_features else [])

    results: dict = {}
    for grid_sp in grid_sps:
        for disp_hw in disp_hws:
            for lam in lambdas:
                for arm in arms:
                    key0 = f"{arm};{grid_sp};{disp_hw};{lam}"
                    per_variant = {
                        f"{key0};{it};{sm}": {"dice": [], "dice30": [], "hd95": [],
                                              "sdlogj": [], "time": [],
                                              "tre": [], "tre30": []}
                        for it in iters for sm in smoothings
                    }
                    cfg = ConvexAdamConfig(
                        mind_r=mind_r, mind_d=mind_d, lambda_weight=lam,
                        grid_sp=grid_sp, disp_hw=disp_hw, dtype=dtype,
                    )
                    for pair in task.registration_val:
                        split = _grid_case(task, pair, arm, cfg, iters, smoothings, key0,
                                           per_variant, output_dir, dev)
                        if timings is not None:
                            timings.append(dict(split, key=key0, case=_case_name(pair)))
                        if verbose:
                            print(f"{key0} case {pair['fixed']}: "
                                  f"{split['load'] + split['register']:.2f}s")
                    for vkey, r in per_variant.items():
                        results[vkey] = {k: np.asarray(v) for k, v in r.items() if len(v)}
                        results[vkey]["median_case_time"] = float(np.median(r["time"]))
    return results


def select_winner(results: dict, repeats: int = 50) -> "tuple[str, np.ndarray]":
    """Official-style winner selection over variant results
    (l2r3.py:298-361): noisy Wilcoxon ranks of {similarity mean, robust30,
    sdlogj, time}, geometric mean double-weighting the similarity metric.
    The similarity is Dice when labels exist, else negated keypoint TRE."""
    keys = list(results.keys())
    if "dice" in results[keys[0]] and len(results[keys[0]].get("dice", [])):
        dice = np.stack([results[k]["dice"].mean(axis=1) for k in keys])
        dice30 = np.stack([results[k]["dice30"] for k in keys])
    else:
        dice = -np.stack([results[k]["tre"].mean(axis=1) for k in keys])
        dice30 = -np.stack([results[k]["tre30"] for k in keys])
    sdlogj = np.stack([results[k]["sdlogj"] for k in keys])
    times = np.stack(
        [np.broadcast_to(results[k]["median_case_time"], dice.shape[1]) for k in keys]
    )
    r0 = noisy_metric_rank(dice, higher_is_better=True, repeats=repeats)
    r1 = noisy_metric_rank(dice30, higher_is_better=True, repeats=repeats)
    r2 = noisy_metric_rank(sdlogj, higher_is_better=False, repeats=repeats)
    r3 = noisy_metric_rank(times, higher_is_better=False, repeats=repeats, noise=0.2)
    agg = aggregate_ranks([r0, r1, r2, r3])
    return keys[int(np.argmax(agg))], agg


def run_testset(
    task: L2RTask,
    winner_key: str,
    output_dir,
    dtype: str = "float32",
    device: "str | torch.device | None" = None,
) -> "list[Path]":
    """Re-run the winning variant on the test pairs and save the submission
    fields; runs on ``cuda`` unless ``device="cpu"``.  The arm prefix of
    ``winner_key`` selects the front-end: MIND descriptors
    (main_for_l2r3_MIND_testset.py:13-88) or semantic one-hot features of
    the predicted labels (main_for_l2r3_nnUNet_testset.py:13-88)."""
    dev = _resolve_device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    arm, grid_sp, disp_hw, lam, it, sm = winner_key.split(";")
    mind_r, mind_d = task.mind_params
    cfg = ConvexAdamConfig(
        mind_r=mind_r, mind_d=mind_d, lambda_weight=float(lam),
        grid_sp=int(grid_sp), disp_hw=int(disp_hw),
        selected_niter=int(it), selected_smooth=int(sm), dtype=dtype,
    )
    written = []
    for pair in task.registration_test:
        case = _load_case(task, pair, device=dev)
        ff, fm = _arm_features(arm, case, mind_r, mind_d, cfg.compute_dtype(dev), dev)
        disp = convex_adam_features(ff, fm, cfg).cpu().numpy()
        out = output_dir / f"disp_{_case_name(pair)}.nii.gz"
        save_volume_nib_order(disp, case["affine"], out)
        written.append(out)
    return written
