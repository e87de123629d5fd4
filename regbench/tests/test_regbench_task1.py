"""The two cells of the task-1 configuration and the coarse stage-1 mix on
the CPU: the MR/CT fixture, the task-1 entry's run and check, the coarse
entry's settings, and the readers of the new per-layer metrics.

``conftest.TINY`` knows only the first two configurations, so the tests
here shrink ``abdomenmrct-task1`` themselves (:func:`shrink_task1`), every
width kept."""

from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny_cell
from rb.spec import HERE, load_module

SEEDS = (2**31 + 11, 2**31 + 12)
#: 48 x 40 x 48 at 2 mm; the original grid 60 x 50 x 60 at 1.6 mm spans the
#: same extent, as 240 x 200 x 240 spans 192 x 160 x 192
TINY_TASK1 = dict(shape=[48, 40, 48], anatomy_ctrl=[3, 3, 3], warp_ctrl=[3, 3, 3],
                  texture_ctrl=[6, 5, 6], warp_max_vox=2.0, anatomy_max_vox=1.0,
                  original={"shape": [60, 50, 60], "spacing_mm": [1.6, 1.6, 1.6],
                            "crop": "whole", "flip": "xy"})


def shrink_task1(root):
    path = root / "regbench" / "configs" / "abdomenmrct-task1.json"
    cfg = json.loads(path.read_text())
    cfg.update(TINY_TASK1)
    path.write_text(json.dumps(cfg))
    return root


@pytest.fixture()
def task1_root(tiny_root):
    return shrink_task1(tiny_root)


def _make(root, seed):
    cell = tiny_cell(root, "mrct-task1-val4")
    return cell.fixture().make(cell.config, seed, torch.device("cpu"))


def _run(root, workload, trace=False):
    from rb.harness import run_cell

    return run_cell(tiny_cell(root, workload), 2**31 + 5, 0.0, trace, "cpu", time.perf_counter())


def test_task1_fixture_repeats_for_a_seed_and_differs_across_seeds(task1_root):
    keys = ("imgs_fixed", "imgs_moving", "masks", "segs_fixed", "segs_moving")
    a, b, c = (_make(task1_root, s) for s in (SEEDS[0], SEEDS[0], SEEDS[1]))
    for k in keys:
        np.testing.assert_array_equal(a[k], b[k])
    assert all(not np.array_equal(a[k], c[k]) for k in keys)
    assert a["imgs_fixed"].shape == (4, 48, 40, 48) and a["num_labels"] == 4
    assert a["original"]["fix_shape"] == (60, 50, 60)


def test_every_organ_in_both_images_and_mr_no_monotone_map_of_ct(tiny_root):
    """At the configuration's own size (one pair, so that it takes
    seconds): labels 1-4 in every fixed and moving volume, the moving
    labels the fixed ones moved; and over the organs' median intensities
    (MR over the fixed labels, CT over the moving ones) one pair of organs
    keeps its order from CT to MR and another reverses it."""
    path = tiny_root / "regbench" / "configs" / "abdomenmrct-task1.json"
    path.write_text(json.dumps({**json.loads(path.read_text()), "pairs": 1}))
    x = _make(tiny_root, SEEDS[0])
    assert x["imgs_fixed"].shape == (1, 192, 160, 192)
    for p in range(1):
        for seg in (x["segs_fixed"][p], x["segs_moving"][p]):
            assert set(np.unique(seg)) == {0, 1, 2, 3, 4}
        assert not np.array_equal(x["segs_fixed"][p], x["segs_moving"][p])
        mr = [np.median(x["imgs_fixed"][p][x["segs_fixed"][p] == k]) for k in range(1, 5)]
        ct = [np.median(x["imgs_moving"][p][x["segs_moving"][p] == k]) for k in range(1, 5)]
        signs = {np.sign((ct[i] - ct[j]) * (mr[i] - mr[j]))
                 for i in range(4) for j in range(i + 1, 4) if abs(ct[i] - ct[j]) > 5.0}
        assert signs == {-1.0, 1.0}, (mr, ct)
        body = x["masks"][p] > 0
        assert 0.3 < body.mean() < 0.8 and (x["segs_fixed"][p][~body] == 0).all()


def test_the_task1_cell_runs_correct_in_a_tiny_root(task1_root):
    line, checks = _run(task1_root, "mrct-task1-val4")
    assert line["failed"] == 0 and line["attempted"] == 4
    assert all(c.ok for c in checks), checks
    assert {c.name for c in checks} == {"missing_calls", "dice_gap", "sdlogj_gap", "map_gap",
                                        "orig_gap"}
    assert set(line["metrics"]) == {"scored_pairs_per_s", "peak_gb", "setup_s"}


@pytest.mark.parametrize("kind", ["organ_moved", "state_unchanged", "answer_altered"])
def test_a_broken_task1_run_is_not_correct(task1_root, kind, monkeypatch):
    """``organ_moved``: the original-space field one voxel longer along the
    first axis over the fixed liver; ``state_unchanged``: the identity
    densified field; ``answer_altered``: the Dice off by 2% where it is
    made."""
    from convexadam_torch.pipeline import challenges

    cell = tiny_cell(task1_root, "mrct-task1-val4")
    inputs = cell.fixture().make(cell.config, 2**31 + 5, torch.device("cpu"))
    if kind == "organ_moved":  # the liver on the half-resolution original grid
        real_map = challenges.task1_field_to_original
        liver = torch.from_numpy((inputs["segs_fixed"] == 1).astype(np.float32))

        def organ(i, shape):
            return torch.nn.functional.interpolate(liver[i][None, None], size=shape,
                                                   mode="nearest")[0, 0].numpy() > 0.5

        calls = iter(range(10**6))

        def map_moved(dense, *a, **k):
            out = real_map(dense, *a, **k)
            i = next(calls) % len(liver)
            out[0][organ(i, out.shape[1:])] += 1.0
            return out

        monkeypatch.setattr(challenges, "task1_field_to_original", map_moved)
    elif kind == "state_unchanged":
        real = challenges._tps_densify
        monkeypatch.setattr(challenges, "_tps_densify",
                            lambda *a, **k: np.zeros_like(real(*a, **k)))
    else:
        scored = challenges.evaluate_field
        monkeypatch.setattr(challenges, "evaluate_field", lambda *a, **k: {
            **scored(*a, **k), "dice": scored(*a, **k)["dice"] * 0.98})
    session = cell.entry().Session(cell, inputs, torch.device("cpu"))
    checks = {c.name: c for c in session.judge([session.call()], 2**31 + 5)}
    failing = {"organ_moved": "map_gap", "state_unchanged": "orig_gap",
               "answer_altered": "dice_gap"}[kind]
    assert not checks[failing].ok, checks


def test_the_coarse_entry_takes_the_twelve_coarse_settings():
    cell = tiny_cell(ROOT, "abdct-sweep1-coarse")
    from rb.settings import stage1_semantic

    drawn = stage1_semantic(100, 1004)
    want = [drawn[i] for i in (2, 3, 4, 5, 6, 8, 11, 15, 16, 17, 18, 19)]
    assert cell.entry().coarse_settings(cell.traffic) == want
    assert all(s["grid_sp"] in (4, 5) for s in want)
    assert cell.entry().GAPS == load_module(HERE / "entries" / "stage1_semantic.py",
                                            "regbench_entry_stage1_semantic").GAPS


def test_the_coarse_cell_runs_correct_in_a_tiny_root(tiny_root):
    line, checks = _run(tiny_root, "abdct-sweep1-coarse")
    assert line["failed"] == 0 and line["attempted"] == 4 * 8
    assert all(c.ok for c in checks), checks


def _reader(name):
    return load_module(HERE / "layer_metrics" / f"{name}.py", f"t_{name}").read


def _span(name, stream_ms, parent=-1):
    return types.SimpleNamespace(name=name, parent=parent, start_ns=0, end_ns=1,
                                 stream_ms=stream_ms)


@pytest.mark.parametrize("metric, span", [("adam_ms", "adam.loop"),
                                          ("densify_ms", "task1.densify"),
                                          ("evaluate_ms", "task1.evaluate")])
def test_span_readers_sum_stream_time_a_pair(metric, span):
    calls = [types.SimpleNamespace(spans=[_span(span, 10.0), _span(span, 30.0),
                                          _span("task1.pair", 1e3)], counters={})
             for _ in range(2)]
    ctx = types.SimpleNamespace(calls=[(0.0, 1.0, r) for r in calls], cases=4)
    assert _reader(metric)(ctx) == pytest.approx(20.0)
    off_card = types.SimpleNamespace(spans=[_span(span, None)], counters={})
    assert _reader(metric)(types.SimpleNamespace(calls=[(0, 1, off_card)], cases=1)) is None
    old = types.SimpleNamespace(dice=None)  # a result with no record
    assert _reader(metric)(types.SimpleNamespace(calls=[(0, 1, old)], cases=1)) is None


def test_convex_stage_reader_sums_the_outermost_convex_spans_of_the_registration():
    spans = [_span("task1.pair", 1e3), _span("task1.register", 500.0, 0),
             _span("convex.features", 3.0, 1), _span("convex.cost_volume", 70.0, 1),
             _span("convex.inner", 50.0, 3), _span("convex.coupled", 10.0, 1),
             _span("adam.loop", 300.0, 1), _span("convex.elsewhere", 9.0, 0)]
    res = types.SimpleNamespace(spans=spans, counters={})
    ctx = types.SimpleNamespace(calls=[(0.0, 1.0, res)] * 2, cases=2)
    assert _reader("convex_stage_ms")(ctx) == pytest.approx(83.0)
    off_card = types.SimpleNamespace(spans=[_span("task1.register", None),
                                            _span("convex.coupled", None, 0)], counters={})
    assert _reader("convex_stage_ms")(types.SimpleNamespace(calls=[(0, 1, off_card)],
                                                            cases=1)) is None
    sweep = types.SimpleNamespace(spans=[_span("sweep.convex", 9.0),
                                         _span("convex.coupled", 8.0, 0)], counters={})
    assert _reader("convex_stage_ms")(types.SimpleNamespace(calls=[(0, 1, sweep)],
                                                            cases=1)) is None


def test_fold_roofline_against_hand_counts():
    from rb.fold import fold_bound_s, fold_bytes

    # task 1's class: K = 17, 4913 candidates over 48 x 40 x 48 = 92160 voxels
    assert fold_bytes(4913, 92160) == 1_811_128_320
    assert fold_bound_s(4913, 92160) == pytest.approx(1_811_128_320 / 3.35e12)
    bound = 1_811_128_320 / 3.35e12
    session = types.SimpleNamespace(fold_class=lambda: (4913, 92160))
    res = types.SimpleNamespace(counters={"coupled_argmin.kernel": 2})
    fold = "coupled_argmin_fold_kernel<4, float>"
    trace = types.SimpleNamespace(device=[(fold, 0.0, 2 * bound, 1), (fold, 0.0, 4 * bound, 1),
                                          ("avg_pool3d", 0.0, 5.0, 2)])
    ctx = types.SimpleNamespace(session=session, trace=trace, calls=[(0, 1, res)])
    assert _reader("fold_roofline")(ctx) == pytest.approx(100.0 / 3)
    ctx.calls = [(0, 1, res)] * 2  # four launches counted, two in the trace: not read
    assert _reader("fold_roofline")(ctx) is None
    ctx.calls = [(0, 1, types.SimpleNamespace(dice=None))]  # a result with no record
    assert _reader("fold_roofline")(ctx) is None
    ctx.calls = [(0, 1, res)]
    ctx.trace = types.SimpleNamespace(device=[("avg_pool3d", 0.0, 5.0, 2)])
    assert _reader("fold_roofline")(ctx) is None
    ctx.session = types.SimpleNamespace()  # a cell whose session names no class
    ctx.trace = trace
    assert _reader("fold_roofline")(ctx) is None


def test_the_task1_session_names_its_fold_class_and_cost_volumes(task1_root):
    cell = tiny_cell(task1_root, "mrct-task1-val4")
    inputs = cell.fixture().make(cell.config, SEEDS[0], torch.device("cpu"))
    session = cell.entry().Session(cell, inputs, torch.device("cpu"))
    assert session.fold_class() == (17 ** 3, 12 * 10 * 12)
    assert session.cost_volumes() == [(12, (12, 10, 12), 8)] * 8


def test_own_field_control_reads_past_the_limits_where_the_program_reads_below(task1_root):
    """``control_own.readings`` at the tiny size: the program's own-field
    gaps within every limit, and the bfloat16-rounded field's SDlogJ and
    map gaps beyond theirs.  Rounding a smooth field of up to two voxels
    moves it by about 0.004 voxels, which flips no label of these small
    organs, so Dice is not held to the control here (its readings at the
    cell's size, on the card: PERF.md section 2)."""
    cell = tiny_cell(task1_root, "mrct-task1-val4")
    control_own = load_module(HERE / "control_own.py", "t_control_own")
    out = control_own.readings(cell, SEEDS[0], torch.device("cpu"))
    assert len(out["pairs"]) == min(cell.traffic["check"]["cases"], 4)
    for key, limit in cell.limits.items():
        if key in out["program"]:
            assert out["program"][key] <= limit, (key, out)
    for key in ("sdlogj_gap", "map_gap"):
        assert out["control"][key] > cell.limits[key], (key, out)
