"""Learn2Reg 2021 task 1 validated over labelled pairs
(``convexadam_torch.pipeline.challenges.task1_validation``) on the CPU, at
48 x 40 x 48 with the recipe's own settings (grid_sp 4, disp_hw 8, inverse
consistency, Adam at grid 3 for 40 iterations with lambda 0.6, the TPS
densification, the original-space map).

* Its fields are those of ``register_tps_densified`` and
  ``task1_field_to_original`` called alone, to the bit, and its scores
  ``evaluate_field``'s.
* It agrees with the benchmark's plain reference
  (``regbench/reference/task1.py``, plain PyTorch, nothing of the port);
  so do the reference's Adam stage, spline and original-space map with the
  port's functions given the same inputs.
* Under a profiler its record holds each pair's layers and counts 40 Adam
  steps a pair; without one it holds nothing.

The inputs are the benchmark's own synthetic MR/CT pairs
(``regbench/fixtures/abdomenmrct-task1.py``), shrunk here.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from convexadam_torch.core.adam import adam_instance_optimisation
from convexadam_torch.core.features import mindssc
from convexadam_torch.core.rigid import thin_plate_dense
from convexadam_torch.pipeline import challenges as ch
from convexadam_torch.pipeline import convex_adam as pca
from convexadam_torch.selfconfig.l2r import evaluate_field

BENCH = pathlib.Path(__file__).resolve().parent.parent / "regbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from rb.spec import load_module  # noqa: E402
from reference import task1 as rt  # noqa: E402
from reference.convex import convex_field, pool  # noqa: E402
from reference.features import mind_ssc  # noqa: E402
from reference.scores import dice, hd95, jacobian_stats, warp_labels  # noqa: E402

torch.set_num_threads(2)

SHAPE = (48, 40, 48)
ORIGINAL = (60, 50, 60)  # 1.6 mm, the same extent as 48 x 40 x 48 at 2 mm
CPU = torch.device("cpu")
CFG = dataclasses.replace(ch.TASK1_CONFIG, dtype="float32")


@pytest.fixture(scope="module")
def pairs():
    cfg = json.loads((BENCH / "configs" / "abdomenmrct-task1.json").read_text())
    cfg.update(shape=list(SHAPE), pairs=2, anatomy_ctrl=[3, 3, 3], warp_ctrl=[3, 3, 3],
               texture_ctrl=[6, 5, 6], warp_max_vox=2.0, anatomy_max_vox=1.0,
               original={"shape": list(ORIGINAL), "spacing_mm": [1.6] * 3, "crop": "whole",
                         "flip": "xy"})
    fixture = load_module(BENCH / "fixtures" / "abdomenmrct-task1.py", "t_task1_fixture")
    x = fixture.make(cfg, 2**31 + 5, CPU)
    x["meta"] = ch.Task1CaseMeta(**x["original"])
    x["config"] = cfg  # the recipe's published settings, as the reference reads them
    return x


def _validate(x):
    n = len(x["imgs_fixed"])
    return ch.task1_validation(x["imgs_fixed"], x["imgs_moving"], x["masks"], x["segs_fixed"],
                               x["segs_moving"], [x["meta"]] * n, x["num_labels"], cfg=CFG,
                               device="cpu")


@pytest.fixture(scope="module")
def runs(pairs):
    """An untraced call and a traced one."""
    off = _validate(pairs)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _validate(pairs)
    return off, on


def test_fields_are_the_recipe_functions_called_alone(pairs, runs):
    off, on = runs
    sp = np.asarray(pairs["spacing"], np.float32)
    for i in range(len(pairs["imgs_fixed"])):
        dense = ch.register_tps_densified(pairs["imgs_fixed"][i], pairs["imgs_moving"][i],
                                          pairs["masks"][i], cfg=CFG, device="cpu")
        alone = ch.task1_field_to_original(dense, sp, sp, pairs["meta"], device="cpu")
        assert alone.shape == (3,) + tuple(n // 2 for n in ORIGINAL)
        np.testing.assert_array_equal(off.fields[i], alone)
        np.testing.assert_array_equal(on.fields[i], alone)  # tracing changes no number
        np.testing.assert_array_equal(off.densified[i], dense)
        scores = evaluate_field(dense, pairs["segs_fixed"][i], pairs["segs_moving"][i],
                                pairs["num_labels"], device="cpu")
        for key, value in scores.items():
            np.testing.assert_array_equal(off.scores[i][key], value)
            np.testing.assert_array_equal(on.scores[i][key], value)


def test_validation_matches_the_plain_reference(pairs, runs):
    """Tolerances, each from what the two computations share: Dice 2e-3,
    about three voxels of the smallest organ here (a label warped across a
    voxel boundary flips on a field's rounding); HD95 0.05 voxels (the same
    flips move a percentile by a fraction of a voxel); SDlogJ 1e-5 (float32
    Jacobians of fields equal to about 1e-4); the original-space field 1e-3
    voxels in the mean (measured 6e-5: the spline's float32 solve and the
    Adam stage's float32 sums in another order)."""
    off, _ = runs
    L = pairs["num_labels"]
    for i in range(len(pairs["imgs_fixed"])):
        f, m = (torch.from_numpy(pairs[k][i]) for k in ("imgs_fixed", "imgs_moving"))
        dense = rt.task1_pair(f, m, pairs["masks"][i], pairs["config"], torch.float32)
        sf, sm = (torch.from_numpy(pairs[k][i]) for k in ("segs_fixed", "segs_moving"))
        warped = warp_labels(sm, dense)
        sdlogj, _ = jacobian_stats(dense)
        orig = rt.field_to_original(dense, pairs["spacing"], pairs["spacing"], pairs["original"])
        got = off.scores[i]
        assert np.max(np.abs(got["dice"] - dice(sf, warped, L))) <= 2e-3
        assert np.max(np.abs(got["hd95"] - hd95(sf, warped, L))) <= 0.05
        assert abs(got["sdlogj"] - sdlogj) <= 1e-5
        assert np.abs(off.fields[i] - orig.numpy()).mean() <= 1e-3
        assert got["dice"].min() > 0.5  # the organs are registered, not missed


def test_reference_adam_stage_matches_adam_instance_optimisation(pairs):
    """The same features and init through the port's Adam stage and the
    reference's: within 1e-4 voxels (measured 1.5e-6; Adam's unit steps
    carry the two float32 gradients' rounding)."""
    f, m = (torch.from_numpy(pairs[k][0]) for k in ("imgs_fixed", "imgs_moving"))
    ff, fm = mindssc(f, 1, 2, dtype=torch.float32), mindssc(m, 1, 2, dtype=torch.float32)
    with torch.no_grad():
        init = pca._convex_stage(ff, fm, CFG, SHAPE, for_adam_init=True)
    patch_fix, patch_mov, grid_init = pca._adam_inputs(ff, fm, init, CFG)
    fitted, _ = adam_instance_optimisation(patch_fix, patch_mov, grid_init, 0.6, 40)
    port = pca._upsample_and_smooth(fitted, SHAPE, 3, 0)
    ref = rt.adam_stage(ff, fm, init, 3, 0.6, 40)
    assert float((port - ref).abs().max()) <= 1e-4


def test_reference_tps_matches_thin_plate_dense(pairs):
    """The same control points and values through the port's spline
    (float32) and the reference's (float64): within 1e-4 in normalized
    units (measured 5.4e-6 on a smooth field; the system here has a
    condition number near 3e5, so float32 carries about 1e-5 of relative
    error into the weights).  The whole densification of a smooth field of
    up to 2 voxels: within 1e-3 voxels."""
    gen = torch.Generator().manual_seed(3)
    x1 = torch.from_numpy(rt.control_points(pairs["masks"][0], 4096, 0))
    # a smooth displacement of up to 0.05 (two voxels) at the control points
    y1 = 0.05 * torch.sin(3.0 * x1 @ torch.randn((3, 3), generator=gen))
    port = thin_plate_dense(x1, y1, SHAPE, 4).permute(3, 0, 1, 2)
    sub = tuple(n // 4 for n in SHAPE)
    axes = [torch.linspace(-1.0, 1.0, n) for n in sub]
    x2 = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    ref = rt.tps(x1, y1, x2).T.reshape((3,) + sub)
    ref = torch.nn.functional.interpolate(ref[None], size=SHAPE, mode="trilinear",
                                          align_corners=True)[0]
    assert float((port - ref).abs().max()) <= 1e-4
    ctrl = torch.randn((3, 4, 4, 4), generator=gen)
    field = torch.nn.functional.interpolate(ctrl[None], size=SHAPE, mode="trilinear",
                                            align_corners=True)[0] * 2.0
    dense = ch._tps_densify(field.permute(1, 2, 3, 0).numpy(), pairs["masks"][0], 4096, 4, True,
                            0, CPU)
    ref = rt.tps_densify(field, pairs["masks"][0], 4096, 4, True, 0)
    assert float((torch.from_numpy(dense).permute(3, 0, 1, 2) - ref).abs().max()) <= 1e-3


@pytest.mark.parametrize("flip", ["xy", "z"])
def test_reference_field_to_original_matches_the_program(flip):
    """A random field to a cropped original grid of other spacings: within
    1e-4 voxels (the voxel grids made two ways, float32)."""
    gen = torch.Generator().manual_seed(4)
    field = torch.randn((3,) + SHAPE, generator=gen) * 2.0
    original = dict(fix_shape=(64, 54, 62), fix_spacing=(1.5, 1.5, 1.6),
                    fix_crop=((2.0, 1.0, 3.0), (62.0, 53.0, 60.0)), mov_shape=(66, 56, 60),
                    mov_spacing=(1.5, 1.4, 1.6), mov_crop=((1.0, 3.0, 2.0), (63.0, 55.0, 59.0)),
                    ref_spacing=(2.0, 2.0, 2.0), flip=flip)
    sp_f, sp_m = np.array([2.0, 2.0, 1.9], np.float32), np.array([2.1, 2.0, 2.0], np.float32)
    port = ch.task1_field_to_original(field.permute(1, 2, 3, 0).numpy(), sp_f, sp_m,
                                      ch.Task1CaseMeta(**original), device="cpu")
    ref = rt.field_to_original(field, sp_f, sp_m, original).numpy()
    assert port.shape == ref.shape == (3, 32, 27, 31)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4)


def test_reference_convex_stage_is_the_programs(pairs):
    """MIND-SSC and the K = 17 convex stage with inverse consistency, float32:
    the reference's field within 1e-4 voxels of the port's (measured 5e-7)."""
    f = torch.from_numpy(pairs["imgs_fixed"][1])
    m = torch.from_numpy(pairs["imgs_moving"][1])
    ff, fm = mindssc(f, 1, 2, dtype=torch.float32), mindssc(m, 1, 2, dtype=torch.float32)
    with torch.no_grad():
        port = pca._convex_stage(ff, fm, CFG, SHAPE, for_adam_init=True)
    rf, rm = mind_ssc(f, 1, 2, torch.float32), mind_ssc(m, 1, 2, torch.float32)
    ref = convex_field(pool(rf, 4, torch.float32), pool(rm, 4, torch.float32), 8, 4, SHAPE)
    assert float((port - ref).abs().max()) <= 1e-4


def test_the_record_holds_each_pairs_layers(pairs, runs):
    _, on = runs
    P = len(pairs["imgs_fixed"])
    spans = on.spans
    count = (lambda name: sum(s.name == name for s in spans))
    for name in ("task1.pair", "task1.register", "task1.densify", "task1.original",
                 "task1.evaluate", "adam.inputs", "adam.loop", "adam.upsample", "tps.fit",
                 "tps.eval", "tps.smooth"):
        assert count(name) == P, name
    assert count("convex.features") == P  # MIND of both volumes, one span a pair
    assert sorted(s.case for s in spans if s.name == "task1.pair") == [(None, i) for i in range(P)]
    for s in spans:  # every span is some pair's
        assert s.case is not None and s.case[1] in range(P), s
        assert s.stream_ms is None  # no card
    assert on.counters["adam.steps"] == 40 * P
    n3 = [(pairs["masks"][i][1::3, 1::3, 1::3] > 0).sum() for i in range(P)]
    assert on.counters["tps.control_points"] == sum(min(4096, int(n)) for n in n3)
    assert on.counters["coupled_argmin.plain"] == 12 * P


def test_without_a_profiler_nothing_is_recorded(runs):
    off, _ = runs
    assert off.spans == [] and off.counters == {}
