"""CLI: MIND ConvexAdam registration, file → displacement field file.

Counterpart of ``convexadam_tpu/cli/register.py``, flag for flag, plus
``--device``.  Equivalent of the reference CLI
(src/convexAdam/convex_adam_MIND.py:251-287): loads fixed/moving volumes
(nib conventions: (i,j,k) data, RAS affine), runs the pipeline, writes
``disp.nii.gz`` with the fixed image's affine.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

import numpy as np


def convex_adam_from_files(
    path_img_fixed,
    path_img_moving,
    mind_r: int = 1,
    mind_d: int = 2,
    lambda_weight: float = 1.25,
    grid_sp: int = 6,
    disp_hw: int = 4,
    selected_niter: int = 80,
    selected_smooth: int = 0,
    grid_sp_adam: int = 2,
    ic: bool = True,
    use_mask: bool = False,
    path_fixed_mask=None,
    path_moving_mask=None,
    result_path="./",
    dtype: str = "auto",
    verbose: bool = False,
    multi_iters: "tuple[int, ...] | None" = None,
    multi_smoothings: "tuple[int, ...] | None" = None,
    semantic: bool = False,
    cost_metric: str = "ssd",
    cost_smooth_passes: int = 2,
    adam_smooth_repeats: int = 3,
    device=None,
) -> "Path | list[Path]":
    """File-level pipeline (reference ``convex_adam``, convex_adam_MIND.py:205-248),
    on ``cuda`` unless ``device="cpu"``.

    With ``multi_iters``/``multi_smoothings`` one run emits every
    (iteration count x post-smoothing) variant from a single Adam
    optimisation, the self-configuring multi-output runner
    (self_configuring/convex_adam_MIND.py:115-147), as
    ``disp_{it}_{sm}.nii.gz`` files.
    """
    import torch

    from convexadam_torch import _resolve_device
    from convexadam_torch.core.features import mindssc, semantic_features
    from convexadam_torch.geometry.io import load_volume_nib_order, save_volume_nib_order
    from convexadam_torch.pipeline.convex_adam import (
        ConvexAdamConfig,
        convex_adam_features,
        convex_adam_multi_output,
    )
    from convexadam_torch.pipeline.preprocess import mask_infill

    dev = _resolve_device(device)
    img_fixed, affine = load_volume_nib_order(path_img_fixed)
    img_moving, _ = load_volume_nib_order(path_img_moving)

    cfg = ConvexAdamConfig(
        mind_r=mind_r,
        mind_d=mind_d,
        lambda_weight=lambda_weight,
        grid_sp=grid_sp,
        disp_hw=disp_hw,
        selected_niter=selected_niter,
        selected_smooth=selected_smooth,
        grid_sp_adam=grid_sp_adam,
        ic=ic,
        dtype=dtype,
        cost_metric=cost_metric,
        cost_smooth_passes=cost_smooth_passes,
        adam_smoother=("box", 3, adam_smooth_repeats),
    )

    t0 = time.time()
    fixed = np.asarray(img_fixed, np.float32)
    moving = np.asarray(img_moving, np.float32)
    if use_mask:
        mask_fixed, _ = load_volume_nib_order(path_fixed_mask)
        mask_moving, _ = load_volume_nib_order(path_moving_mask)
        fixed = mask_infill(fixed, np.asarray(mask_fixed, np.float32), device=dev)
        moving = mask_infill(moving, np.asarray(mask_moving, np.float32), device=dev)

    dt = cfg.compute_dtype(dev)
    with torch.no_grad():
        if semantic:
            # nnU-Net front-end: the inputs are predicted label maps
            # (convex_adam_nnUNet.py:19-38,162-191)
            pf = torch.from_numpy(fixed.round().astype(np.int32)).to(dev)
            pm = torch.from_numpy(moving.round().astype(np.int32)).to(dev)
            nl = int(max(pf.max(), pm.max())) + 1
            feat_fix, feat_mov = semantic_features(pf, pm, num_labels=nl, dtype=dt)
        else:
            feat_fix = mindssc(torch.from_numpy(fixed).to(dev), cfg.mind_r, cfg.mind_d, dtype=dt)
            feat_mov = mindssc(torch.from_numpy(moving).to(dev), cfg.mind_r, cfg.mind_d, dtype=dt)

    if multi_iters:
        smoothings = tuple(multi_smoothings or (0, 3, 5))
        fields = convex_adam_multi_output(
            feat_fix, feat_mov, cfg, tuple(multi_iters), smoothings, device=dev
        ).cpu().numpy()
        if verbose:
            print(f"case time: {time.time() - t0}")
        written = []
        for a, it in enumerate(multi_iters):
            for b, sm in enumerate(smoothings):
                out = Path(result_path) / f"disp_{it}_{sm}.nii.gz"
                save_volume_nib_order(fields[a, b], affine, out)
                written.append(out)
        return written

    disp = convex_adam_features(feat_fix, feat_mov, cfg).cpu().numpy()
    if verbose:
        print(f"case time: {time.time() - t0}")
    out = Path(result_path) / "disp.nii.gz"
    save_volume_nib_order(disp.astype(np.float32), affine, out)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="ConvexAdam MIND registration (PyTorch + CUDA)")
    parser.add_argument("-f", "--path_img_fixed", type=str, required=True)
    parser.add_argument("-m", "--path_img_moving", type=str, required=True)
    parser.add_argument("--mind_r", type=int, default=1)
    parser.add_argument("--mind_d", type=int, default=2)
    parser.add_argument("--lambda_weight", type=float, default=1.25)
    parser.add_argument("--grid_sp", type=int, default=6)
    parser.add_argument("--disp_hw", type=int, default=4)
    parser.add_argument("--selected_niter", type=int, default=80)
    parser.add_argument("--selected_smooth", type=int, default=0)
    parser.add_argument("--grid_sp_adam", type=int, default=2)
    parser.add_argument("--ic", choices=("True", "False"), default="True")
    parser.add_argument("--use_mask", choices=("True", "False"), default="False")
    parser.add_argument("--path_mask_fixed", type=str, default=None)
    parser.add_argument("--path_mask_moving", type=str, default=None)
    parser.add_argument("--result_path", type=str, default="./")
    parser.add_argument(
        "--dtype", type=str, default="auto",
        choices=("auto", "float32", "bfloat16"),
        help="'auto' = bfloat16 on the card, float32 on the CPU",
    )
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--multi_iters", type=str, default=None,
        help="comma list, e.g. 40,60,80: emit every (iters x smoothing) "
        "variant from one run (the 9-variant self-configuring runner)",
    )
    parser.add_argument(
        "--multi_smoothings", type=str, default="0,3,5",
        help="comma list of post-smoothing cascades for --multi_iters",
    )
    parser.add_argument(
        "--semantic", action="store_true",
        help="inputs are predicted label maps; use weighted one-hot "
        "semantic features (the reference's convex_adam_nnUNet CLI)",
    )
    parser.add_argument(
        "--cost_metric", type=str, default="ssd", choices=("ssd", "sad"),
        help="cost-volume metric ('sad' = the OASIS task-3 recipe, "
        "l2r_2021_convexAdam_task3_docker.py:54)",
    )
    parser.add_argument(
        "--cost_smooth_passes", type=int, default=2,
        help="3^3 box passes over the cost volume (1 in the task-2/3 "
        "recipes, l2r_2021_convexAdam_task2_docker.py:60)",
    )
    parser.add_argument(
        "--adam_smooth_repeats", type=int, default=3,
        help="cascaded 3^3 boxes on the Adam grid per iteration (2 in the "
        "task-3 recipe, l2r_2021_convexAdam_task3_docker.py:191)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ('cuda' or 'cpu')")
    args = parser.parse_args(argv)
    os.makedirs(args.result_path, exist_ok=True)
    out = convex_adam_from_files(
        path_img_fixed=args.path_img_fixed,
        path_img_moving=args.path_img_moving,
        mind_r=args.mind_r,
        mind_d=args.mind_d,
        lambda_weight=args.lambda_weight,
        grid_sp=args.grid_sp,
        disp_hw=args.disp_hw,
        selected_niter=args.selected_niter,
        selected_smooth=args.selected_smooth,
        grid_sp_adam=args.grid_sp_adam,
        ic=(args.ic == "True"),
        use_mask=(args.use_mask == "True"),
        path_fixed_mask=args.path_mask_fixed,
        path_moving_mask=args.path_mask_moving,
        result_path=args.result_path,
        dtype=args.dtype,
        verbose=args.verbose,
        multi_iters=(
            tuple(int(x) for x in args.multi_iters.split(",")) if args.multi_iters else None
        ),
        multi_smoothings=tuple(int(x) for x in args.multi_smoothings.split(",")),
        semantic=args.semantic,
        cost_metric=args.cost_metric,
        cost_smooth_passes=args.cost_smooth_passes,
        adam_smooth_repeats=args.adam_smooth_repeats,
        device=args.device,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
