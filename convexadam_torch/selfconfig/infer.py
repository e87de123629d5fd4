"""Test-set inference with chosen sweep settings.

Counterpart of ``convexadam_tpu/selfconfig/infer.py``; reference:
infer_convexadam.py:47-251: rerun the chosen convex setting and the decoded
Adam variant on the test pairs and write ``disp_<f>_<m>.nii.gz``
displacement fields.

The composition is the JAX module's own, not the sweep engine's stage 2:
the Adam features are float32 one-hot features made with ``mult=nn_mult``
(the engine makes them with ``mult=1``, scales them after, and keeps them
in the ``"auto"`` dtype), and Adam runs exactly ``iters`` steps.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.adam import adam_instance_optimisation
from convexadam_torch.core.features import label_counts, semantic_features
from convexadam_torch.core.smoothing import box_smooth_repeated
from convexadam_torch.core.warp import resize_trilinear
from convexadam_torch.geometry.io import load_volume_nib_order, save_volume_nib_order
from convexadam_torch.pipeline.convex_adam import (
    ConvexAdamConfig,
    _adam_inputs,
    _upsample_and_smooth,
)
from convexadam_torch.selfconfig.engine import convex_field_semantic
from convexadam_torch.selfconfig.settings import (
    decode_adam_variant,
    stage1_settings,
    stage2_settings,
)


def _register_pair(pf: torch.Tensor, pm: torch.Tensor, st1, st2, iters: int, kks: int,
                  num_labels: int) -> torch.Tensor:
    """One test pair of label volumes (H, W, D) on their device: the convex
    stage of ``st1`` (coarse, then resized), Adam of ``st2`` for ``iters``
    steps on float32 features, the upsampled field and ``kks`` extra 3^3
    box passes → (H, W, D, 3) voxels (infer_convexadam.py:162-240).
    ``num_labels`` counts the labels without the background."""
    shape = tuple(pf.shape)
    nl = num_labels + 1
    g2 = st2.grid_sp_adam
    with torch.no_grad():
        disp_lr = convex_field_semantic(pf, pm, st1.nn_mult, nl, st1.grid_sp, st1.disp_hw,
                                        coarse=True, device=pf.device)
        disp_hr = resize_trilinear(disp_lr, shape, align_corners=False)
        ff, fm = semantic_features(pf, pm, num_labels=nl, mult=st1.nn_mult)
        cfg = ConvexAdamConfig(grid_sp_adam=g2, dtype="float32")
        patch_fix, patch_mov, init = _adam_inputs(ff, fm, disp_hr, cfg)
        counts = label_counts(pf, nl) + label_counts(pm, nl)
        n_ch = float((counts > 0).sum())
    del ff, fm, disp_hr
    with torch.enable_grad():
        final, _ = adam_instance_optimisation(
            patch_fix, patch_mov, init, st2.lambda_weight, niter=iters,
            smoother=("bank", st2.effective_avg_n), cost_scale=n_ch,
        )
    with torch.no_grad():
        out = _upsample_and_smooth(final, shape, g2, 0)
        for _ in range(kks):
            out = box_smooth_repeated(out, 3, 1)
        return out.permute(1, 2, 3, 0)


def run_inference(
    config: dict,
    convex_s: int,
    adam_s1: int,
    adam_s2: int,
    output_dir=None,
    verbose: bool = False,
    device: "str | torch.device | None" = None,
) -> "list[Path]":
    """Run the chosen settings on ``config['test_pair']`` over
    ``config['test']`` case ids (infer_convexadam.py:162-240), on ``cuda``
    unless ``device="cpu"``."""
    dev = _resolve_device(device)
    st1 = stage1_settings()[convex_s]
    st2 = stage2_settings()[adam_s1]
    iters, kks = decode_adam_variant(adam_s2)

    num_labels = config["num_labels"] - 1
    H, W, D = config["HWD"]
    test_ids = config.get("test", config.get("topk"))
    test_pairs = [tuple(p) for p in config.get("test_pair", config.get("topk_pair"))]
    output_dir = Path(output_dir or config.get("output_dir", "."))
    output_dir.mkdir(parents=True, exist_ok=True)

    preds, affines = [], []
    for k in test_ids:
        p, aff = load_volume_nib_order(config["f_predict"] % k)
        preds.append(torch.from_numpy(np.asarray(p[:H, :W, :D], np.int32)).to(dev))
        affines.append(aff)

    written = []
    for (i, j) in test_pairs:
        disp = _register_pair(preds[i], preds[j], st1, st2, iters, kks, num_labels)
        out = output_dir / f"disp_{test_ids[i]}_{test_ids[j]}.nii.gz"
        save_volume_nib_order(disp.cpu().numpy(), affines[i], out)
        written.append(out)
        if verbose:
            print(f"wrote {out}")
    return written
