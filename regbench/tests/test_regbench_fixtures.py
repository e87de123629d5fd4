"""The inputs repeat for a seed and differ across seeds."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny_cell

SEEDS = (2**31 + 11, 2**31 + 12)


def _make(root, workload, seed):
    cell = tiny_cell(root, workload)
    return cell.fixture().make(cell.config, seed, torch.device("cpu"))


def _arrays(x):
    keys = ("segs", "preds") if "segs" in x else ("imgs_fixed", "imgs_moving")
    out = [x[k] for k in keys]
    if "kpts_fixed" in x:
        out += list(x["kpts_fixed"]) + list(x["kpts_moving"])
    return out


@pytest.mark.parametrize("workload", ["abdct-sweep1", "nlst-sweep1"])
def test_fixture_repeats_for_a_seed_and_differs_across_seeds(tiny_root, workload):
    a, b, c = (_make(tiny_root, workload, s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    for x, y in zip(_arrays(a), _arrays(b)):
        np.testing.assert_array_equal(x, y)
    assert any(x.shape != y.shape or not np.array_equal(x, y)
               for x, y in zip(_arrays(a), _arrays(c)))


def test_semantic_subjects_hold_every_organ_and_predictions_differ(tiny_root):
    x = _make(tiny_root, "abdct-sweep1", SEEDS[0])
    L = x["num_labels"]
    assert x["segs"].shape == x["preds"].shape == (10, 24, 20, 32)
    assert x["segs"].max() <= L and (x["segs"] != x["preds"]).any()
    assert not np.array_equal(x["segs"][0], x["segs"][1])


def test_moving_keypoints_follow_the_breathing_field(tiny_root):
    """The moving volume at each moving keypoint reads what the fixed one
    reads at its fixed keypoint (before noise: the fixed volume shows
    through the field), so the keypoints agree with the images."""
    x = _make(tiny_root, "nlst-sweep1", SEEDS[0])
    assert x["imgs_fixed"].shape == (4, 28, 24, 28)
    for kf, km in zip(x["kpts_fixed"], x["kpts_moving"]):
        assert kf.shape == km.shape and kf.shape[1] == 3 and len(kf) > 10
        assert np.abs(kf - km).max() < 4.0
