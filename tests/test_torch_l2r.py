"""The port's Learn2Reg task driver (``convexadam_torch/selfconfig/l2r.py``)
and test-set inference (``selfconfig/infer.py``) against the JAX package,
on the CPU.

The task layouts are the JAX package's own test layouts (``tests/test_l2r.py``):
images, labels and predicted labels of nested boxes at 36^3, written by
the JAX package and read by both.  Loading is numpy in both packages and
compared exactly; the ranking is fed one shared ``results`` dict, because
``select_winner`` ranks wall time, which differs between the packages.
The registrations differ where the two packages' Adam loops part (argmin
ties and one-sided derivatives at exactly-zero displacements, ROADMAP §C),
so the grid's fields and metrics are held to the envelopes stated beside
each assert, measured on the CPU.
"""

import json

import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

import convexadam_torch.selfconfig.l2r as tl
import convexadam_tpu.selfconfig.l2r as jl
from convexadam_torch.selfconfig import rank as trank
from convexadam_torch.selfconfig.infer import run_inference as t_infer
from convexadam_tpu.geometry.io import load_volume_nib_order, save_volume_nib_order
from convexadam_tpu.selfconfig import rank as jrank
from convexadam_tpu.selfconfig.infer import run_inference as j_infer

torch.set_num_threads(2)

_GRID = dict(iters=(20, 40), smoothings=(0, 3), verbose=False, grid_override=([4], [2], [1.0]))


@pytest.fixture(scope="module")
def task_root(tmp_path_factory):
    """``SynthTask`` of the JAX package's test, plus masks and a labels table."""
    root = tmp_path_factory.mktemp("l2rdata")
    task = root / "SynthTask"
    for sub in ("images", "labels", "predictedlabels", "masks"):
        (task / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    affine = np.eye(4)
    shape = (36, 36, 36)
    mask = np.zeros(shape, np.float32)
    mask[3:33, 4:32, 2:34] = 1.0
    for i in range(3):
        o = rng.integers(-2, 3, 3)
        seg = np.zeros(shape, np.int32)
        seg[8 + o[0]: 28 + o[0], 8 + o[1]: 28 + o[1], 8 + o[2]: 28 + o[2]] = 1
        seg[14 + o[0]: 22 + o[0], 14 + o[1]: 22 + o[1], 14 + o[2]: 22 + o[2]] = 2
        vol = uniform_filter(rng.standard_normal(shape).astype(np.float32), 2) * 30 + seg * 60.0
        name = f"case_{i:04d}.nii.gz"
        save_volume_nib_order(vol, affine, task / "images" / name)
        save_volume_nib_order(seg.astype(np.float32), affine, task / "labels" / name)
        save_volume_nib_order(np.roll(seg, 1, axis=0).astype(np.float32), affine,
                              task / "predictedlabels" / name)
        save_volume_nib_order(mask, affine, task / "masks" / name)
    dataset = {
        "modality": {"0": "MR"},
        "provided_data": {"0": ["image", "label"]},
        "labels": {"0": "background", "1": "organ_a", "2": "organ_b"},
        "registration_val": [
            {"fixed": "images/case_0000.nii.gz", "moving": "images/case_0001.nii.gz"},
        ],
        "registration_test": [
            {"fixed": "images/case_0000.nii.gz", "moving": "images/case_0002.nii.gz"},
        ],
    }
    (task / "SynthTask_dataset.json").write_text(json.dumps(dataset))
    (task / "SynthTask_VAL_evaluation_config.json").write_text(json.dumps({
        "evaluation_methods": [{"name": "sdlogj"}, {"name": "dice"}],
        "expected_shape": list(shape)}))
    return root


def _with_masks(root, name="SynthMask"):
    """The same task, its dataset also providing masks."""
    src = root / "SynthTask"
    dst = root / name
    if not dst.exists():
        dst.symlink_to(src, target_is_directory=True)
        data = json.loads((src / "SynthTask_dataset.json").read_text())
        data["provided_data"] = {"0": ["image", "label", "mask"]}
        (src / f"{name}_dataset.json").write_text(json.dumps(data))
    return name


def _task_fields(t):
    return {k: getattr(t, k) for k in (
        "name", "modality_fixed", "modality_moving", "semantic_features", "use_mask",
        "keypoint_space", "expected_shape", "num_labels", "registration_val",
        "registration_test", "evaluation_methods")}


def test_task_load_matches_jax(task_root):
    t, j = tl.L2RTask.load(task_root, "SynthTask"), jl.L2RTask.load(task_root, "SynthTask")
    assert _task_fields(t) == _task_fields(j)
    assert t.num_labels == 2 and t.semantic_features and not t.use_mask
    assert t.grid_options == j.grid_options and t.mind_params == j.mind_params
    big = dict(task_dir=None, name="big", expected_shape=(256, 192, 224), modality_fixed="US")
    assert tl.L2RTask(**big).grid_options == jl.L2RTask(**big).grid_options
    assert tl.L2RTask(**big).mind_params == jl.L2RTask(**big).mind_params == (3, 3)


@pytest.mark.parametrize("masked", [False, True])
def test_load_case_matches_jax(task_root, masked):
    """Images, affine, spacing, labels, predictions; with masks, the infill
    (the port's native EDT), bit for bit."""
    name = _with_masks(task_root) if masked else "SynthTask"
    t_task, j_task = tl.L2RTask.load(task_root, name), jl.L2RTask.load(task_root, name)
    assert t_task.use_mask is masked
    pair = t_task.registration_val[0]
    t_case = tl._load_case(t_task, pair, device="cpu")
    j_case = jl._load_case(j_task, pair)
    assert set(t_case) == set(j_case)
    for k, v in j_case.items():
        if v is None or np.isscalar(v):
            assert t_case[k] == v, k
        else:
            assert t_case[k].dtype == v.dtype, k
            np.testing.assert_array_equal(t_case[k], v, err_msg=k)
    if masked:
        plain = tl._load_case(tl.L2RTask.load(task_root, "SynthTask"), pair, device="cpu")
        assert (t_case["fixed"] != plain["fixed"]).any()


def test_world_keypoints_and_gt_fallback_match_jax(tmp_path):
    """``keypoint_space`` "world": mm rows through each image's inverse
    affine; no ``predictedlabels``: the ground truth is the nnUNet arm's
    input; a bad space raises in both packages."""
    task = tmp_path / "WorldKey"
    for sub in ("images", "keypoints", "labels"):
        (task / sub).mkdir(parents=True)
    rng = np.random.default_rng(5)
    affine = np.diag([2.0, 2.0, 3.0, 1.0])
    affine[:3, 3] = [-10.0, 4.0, 7.0]
    vol = rng.standard_normal((16, 16, 16)).astype(np.float32)
    seg = (vol > 0.5).astype(np.float32)
    for c in ("c0", "c1"):
        save_volume_nib_order(vol, affine, task / "images" / f"{c}.nii.gz")
        save_volume_nib_order(seg, affine, task / "labels" / f"{c}.nii.gz")
    kf_vox = rng.uniform(1, 14, (6, 3))
    np.savetxt(task / "keypoints" / "c0.csv", kf_vox @ affine[:3, :3].T + affine[:3, 3],
               delimiter=",")
    np.savetxt(task / "keypoints" / "c1.csv", kf_vox @ affine[:3, :3].T + affine[:3, 3] + 1.5,
               delimiter=",")
    dataset = {"modality": {"0": "CT"}, "provided_data": {"0": ["image", "keypoints", "label"]},
               "keypoint_space": "world",
               "registration_val": [{"fixed": "images/c0.nii.gz", "moving": "images/c1.nii.gz"}]}
    (task / "WorldKey_dataset.json").write_text(json.dumps(dataset))
    t_task, j_task = tl.L2RTask.load(tmp_path, "WorldKey"), jl.L2RTask.load(tmp_path, "WorldKey")
    assert _task_fields(t_task) == _task_fields(j_task)
    pair = t_task.registration_val[0]
    t_case, j_case = tl._load_case(t_task, pair, device="cpu"), jl._load_case(j_task, pair)
    for k in ("kf", "km", "spacing", "pred_f", "pred_m", "seg_f"):
        np.testing.assert_array_equal(t_case[k], j_case[k], err_msg=k)
    np.testing.assert_allclose(t_case["kf"], kf_vox, atol=1e-9)
    assert t_case["pred_f"] is t_case["seg_f"]
    dataset["keypoint_space"] = "parsec"
    (task / "WorldKey_dataset.json").write_text(json.dumps(dataset))
    for pkg in (tl, jl):
        with pytest.raises(ValueError, match="keypoint_space"):
            pkg.L2RTask.load(tmp_path, "WorldKey")


def _shared_results(rng, n_var, cases, tre=False):
    results = {}
    for i in range(n_var):
        r = {"sdlogj": rng.random(cases) * 0.1, "median_case_time": float(rng.random() + 1)}
        if tre:
            r["tre"] = rng.random((cases, 10)) + (i % 5)
            r["tre30"] = rng.random(cases) + (i % 5)
        else:
            r["dice"] = rng.random((cases, 3)) * 0.5 + 0.4 + 0.01 * i
            r["dice30"] = rng.random(cases) * 0.5 + 0.3
        results[f"MIND;4;2;1.0;{i};0"] = r
    return results


@pytest.mark.parametrize("n_var,cases,tre", [(8, 3, False), (18, 1, False), (12, 4, True)])
def test_select_winner_on_shared_results(n_var, cases, tre):
    """The same results dict → the same winner key and the same aggregate
    ranks, exactly."""
    results = _shared_results(np.random.default_rng(n_var), n_var, cases, tre)
    wt, at = tl.select_winner(results, repeats=6)
    wj, aj = jl.select_winner(results, repeats=6)
    assert wt == wj
    np.testing.assert_array_equal(at, aj)


@pytest.mark.parametrize("n,c", [(3, 1), (20, 2), (40, 5), (108, 3), (17, 12)])
def test_scores_better_equals_the_loop_of_ranksums(n, c):
    """The port tests all pairs at once; the JAX package loops over
    ``scipy.stats.ranksums``: equal counts, with ties and equal rows."""
    rng = np.random.default_rng(n * 100 + c)
    m = rng.random((n, c))
    m[n // 2] = m[0]
    m[-1] = np.round(m[-1], 1)
    if n > 4:
        m[3] += 0.5
    np.testing.assert_array_equal(trank.scores_better(m), jrank.scores_better(m))


@pytest.fixture(scope="module")
def grids(task_root, tmp_path_factory):
    """Both packages' validation grids of one setting x both arms x 2 x 2
    variants on ``SynthTask``, their output directories and the port's
    timings."""
    out = tmp_path_factory.mktemp("grid")
    timings = []
    rt = tl.run_validation_grid(tl.L2RTask.load(task_root, "SynthTask"), out / "t",
                                device="cpu", timings=timings, **_GRID)
    rj = jl.run_validation_grid(jl.L2RTask.load(task_root, "SynthTask"), out / "j", **_GRID)
    return rt, rj, out, timings


def test_validation_grid_matches_jax(grids):
    """The same variant keys, metric keys, shapes and file names; metrics
    within the multi-output envelope.  Measured on this task: Dice
    |diff| <= 1.0e-3, HD95 equal, SDlogJ relative 1.9e-3; bounds 5e-3, 0.5
    voxels, 1e-2."""
    rt, rj, out, _ = grids
    assert list(rt) == list(rj)
    for key in rj:
        assert set(rt[key]) == set(rj[key]), key
        for k, v in rj[key].items():
            if k in ("time", "median_case_time"):
                continue
            assert np.shape(rt[key][k]) == np.shape(v), (key, k)
        assert np.abs(rt[key]["dice"] - rj[key]["dice"]).max() <= 5e-3, key
        assert np.abs(rt[key]["hd95"] - rj[key]["hd95"]).max() <= 0.5, key
        rel = np.abs(rt[key]["sdlogj"] - rj[key]["sdlogj"]) / np.abs(rj[key]["sdlogj"])
        assert rel.max() <= 1e-2, key
    assert sorted(p.name for p in (out / "t").iterdir()) == sorted(
        p.name for p in (out / "j").iterdir())


def test_validation_grid_fields_match_jax(grids):
    """Each written field against the JAX package's: the files carry the
    same affine; the fields part where the Adam loops part (measured mean
    |diff| at most 0.029 voxels, 99th percentile 0.29); bounds 0.05 and
    1.0 voxels."""
    _, _, out, _ = grids
    for path in sorted((out / "j").iterdir()):
        dj, aj = load_volume_nib_order(path)
        dt, at = load_volume_nib_order(out / "t" / path.name)
        np.testing.assert_array_equal(at, aj)
        diff = np.abs(dt - dj)
        assert diff.mean() <= 0.05 and np.quantile(diff, 0.99) <= 1.0, (path.name, diff.mean())


def test_validation_grid_records_host_split(grids):
    """With ``timings``, one record a (setting, arm, case) of load,
    register, evaluate and write seconds; the winner beats the identity."""
    rt, _, _, timings = grids
    assert [t["key"] for t in timings] == ["MIND;4;2;1.0", "nnUNet;4;2;1.0"]
    for t in timings:
        assert all(t[k] > 0 for k in ("load", "register", "evaluate", "write"))
    winner, agg = tl.select_winner(rt, repeats=5)
    assert winner in rt and agg.shape == (len(rt),)
    assert rt[winner]["dice"].mean() > 0.5


def test_testset_matches_jax(task_root, tmp_path):
    """``run_testset`` of both arms: the same file names and affine, and
    the same registration quality.  On this test pair the one-hot arm's
    cost volume has argmin ties that the packages break differently (the
    fields differ by 0.13 voxels on average), so the fields are held by
    the Dice of the warped labels: measured |diff| at most 5.5e-3, bound
    2e-2."""
    t_task, j_task = tl.L2RTask.load(task_root, "SynthTask"), jl.L2RTask.load(task_root, "SynthTask")
    labels = task_root / "SynthTask" / "labels"
    seg_f = load_volume_nib_order(labels / "case_0000.nii.gz")[0].astype(np.int32)
    seg_m = load_volume_nib_order(labels / "case_0002.nii.gz")[0].astype(np.int32)
    for key in ("MIND;4;2;1.0;20;3", "nnUNet;4;2;1.0;20;0"):
        wt = tl.run_testset(t_task, key, tmp_path / "t", device="cpu")
        wj = jl.run_testset(j_task, key, tmp_path / "j")
        assert [p.name for p in wt] == [p.name for p in wj] == ["disp_case_0000_case_0002.nii.gz"]
        dt, at = load_volume_nib_order(wt[0])
        dj, aj = load_volume_nib_order(wj[0])
        np.testing.assert_array_equal(at, aj)
        dice_t = tl.evaluate_field(dt, seg_f, seg_m, 2, device="cpu")["dice"]
        dice_j = tl.evaluate_field(dj, seg_f, seg_m, 2, device="cpu")["dice"]
        assert np.abs(dice_t - dice_j).max() <= 2e-2, (key, dice_t, dice_j)
        assert dice_t.mean() > 0.9, key


def test_driver_defaults_to_cuda(task_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = tl.L2RTask.load(task_root, "SynthTask")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.run_validation_grid(task, tmp_path, **_GRID)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.run_testset(task, "MIND;4;2;1.0;20;0", tmp_path)


@pytest.fixture(scope="module")
def infer_config(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    rng = np.random.default_rng(0)
    shape = (32, 32, 32)
    for k in range(3):
        o = rng.integers(-2, 3, 3)
        seg = np.zeros(shape, np.float32)
        seg[8 + o[0]: 26 + o[0], 8 + o[1]: 24 + o[1], 8 + o[2]: 24 + o[2]] = 1
        seg[12 + o[0]: 20 + o[0], 12 + o[1]: 20 + o[1], 12 + o[2]: 20 + o[2]] = 2
        save_volume_nib_order(seg, np.diag([1.0, 1.2, 0.9, 1.0]), root / f"pred_{k}.nii.gz")
    return {"topk": [0, 1, 2], "topk_pair": [[0, 1]], "test": [0, 1, 2],
            "test_pair": [[0, 2], [1, 2]], "HWD": list(shape),
            "f_predict": str(root / "pred_%d.nii.gz"), "f_gt": str(root / "pred_%d.nii.gz"),
            "num_labels": 3, "output_dir": str(root / "fields")}, root


@pytest.mark.parametrize("convex_s,adam_s1,adam_s2", [(3, 0, 1), (4, 1, 6)])
def test_run_inference_matches_jax(infer_config, convex_s, adam_s1, adam_s2):
    """The JAX module's composition (float32 features made with
    ``mult=nn_mult``, Adam for exactly ``iters`` steps): the same files and
    affines; fields equal to float32 rounding on these pairs (measured
    mean |diff| at most 1.5e-5 voxels, max 1.0e-4; bounds 1e-4 and 1e-3)."""
    config, root = infer_config
    out_t = t_infer(config, convex_s, adam_s1, adam_s2, output_dir=root / f"t{convex_s}",
                    device="cpu")
    out_j = j_infer(config, convex_s, adam_s1, adam_s2, output_dir=root / f"j{convex_s}")
    assert [p.name for p in out_t] == [p.name for p in out_j] == ["disp_0_2.nii.gz",
                                                                   "disp_1_2.nii.gz"]
    for pt, pj in zip(out_t, out_j):
        dt, at = load_volume_nib_order(pt)
        dj, aj = load_volume_nib_order(pj)
        np.testing.assert_array_equal(at, aj)
        diff = np.abs(dt - dj)
        assert diff.mean() <= 1e-4 and diff.max() <= 1e-3, (pt.name, diff.mean(), diff.max())
