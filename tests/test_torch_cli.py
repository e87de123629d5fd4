"""The port's command lines (``convexadam_torch/cli``) and its
reference-signature API (``convexadam_torch/compat.py``) against the JAX
package's, on the CPU (``--device cpu``), at small sizes.

Both packages read the same input files and write their own; the files are
compared by their arrays and affines.  The JAX package's float32 CPU path
is the comparison for the fields; where they part (the Adam loops after a
few dozen iterations, argmin ties) each assert states its envelope,
measured on the CPU.
"""

import contextlib
import gzip
import io
import json
import pathlib
import struct
import tomllib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import convexadam_torch.compat as tcompat
import convexadam_tpu.compat as jcompat
from convexadam_torch.cli import apply as t_apply
from convexadam_torch.cli import l2r as t_l2r
from convexadam_torch.cli import register as t_register
from convexadam_torch.cli import sweep as t_sweep
from convexadam_torch.cli import translation as t_translation
from convexadam_torch.geometry.image import MedicalImage as TImage
from convexadam_tpu.cli import apply as j_apply
from convexadam_tpu.cli import register as j_register
from convexadam_tpu.cli import sweep as j_sweep
from convexadam_tpu.cli import translation as j_translation
from convexadam_tpu.geometry.image import MedicalImage as JImage
from convexadam_tpu.geometry.io import (
    load_volume_nib_order,
    read_image,
    save_volume_nib_order,
    write_image,
)

torch.set_num_threads(2)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_SMALL = ["--grid_sp", "4", "--disp_hw", "2", "--selected_niter", "20", "--dtype", "float32"]


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    """The JAX CLIs enable a persistent compile cache under ``~``; keep it off."""
    monkeypatch.setenv("CONVEXADAM_NO_COMPILE_CACHE", "1")


def _volume(shape, seed):
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))
    t = t[None, None]
    for _ in range(2):
        t = F.avg_pool3d(t, 3, stride=1, padding=1)
    vol = t[0, 0].numpy()
    return (vol - vol.mean()) / vol.std() * 100.0


_SHIFT = (4, -5, 3)
_AFFINE = np.array([[0.9, 0, 0, -10.0], [0, 1.1, 0, 5.0], [0, 0, 1.3, 2.5], [0, 0, 0, 1.0]])


@pytest.fixture(scope="module")
def pair_files(tmp_path_factory):
    """A 32^3 MIND pair rolled by (4, -5, 3), with box masks, as NIfTI: at
    grid_sp 4 its convex init has no exactly-zero component, where the two
    packages' data terms take different one-sided derivatives (ROADMAP §C)."""
    d = tmp_path_factory.mktemp("pair")
    vol = _volume((32, 32, 32), 1)
    mov = np.roll(vol, _SHIFT, axis=(0, 1, 2))
    mask = np.zeros(vol.shape, np.float32)
    mask[3:29, 4:30, 2:31] = 1.0
    save_volume_nib_order(vol, _AFFINE, d / "f.nii.gz")
    save_volume_nib_order(mov, _AFFINE, d / "m.nii.gz")
    save_volume_nib_order(mask, _AFFINE, d / "mask_f.nii.gz")
    save_volume_nib_order(np.roll(mask, _SHIFT, axis=(0, 1, 2)), _AFFINE, d / "mask_m.nii.gz")
    return d


def _both_register(d, out, extra):
    args = ["-f", str(d / "f.nii.gz"), "-m", str(d / "m.nii.gz"), *_SMALL, *extra]
    t_register.main(args + ["--result_path", str(out / "t"), "--device", "cpu"])
    j_register.main(args + ["--result_path", str(out / "j")])


def _absdiff(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))


def _read_pair(out, name):
    dt, at = load_volume_nib_order(out / "t" / name)
    dj, aj = load_volume_nib_order(out / "j" / name)
    np.testing.assert_array_equal(at, aj)
    return dt, dj


@pytest.mark.parametrize("use_mask", [False, True])
def test_register_cli_matches_jax(pair_files, tmp_path, use_mask):
    """``disp.nii.gz`` of both CLIs, with and without ``--use_mask``: the
    fixed image's affine, the shift recovered, the fields within the Adam
    loops' float32 parting at 20 iterations (measured mean |diff| at most
    8.8e-5 voxels, max 4.2e-3; bounds 1e-3 and 2e-2)."""
    extra = (["--use_mask", "True", "--path_mask_fixed", str(pair_files / "mask_f.nii.gz"),
              "--path_mask_moving", str(pair_files / "mask_m.nii.gz")] if use_mask else [])
    _both_register(pair_files, tmp_path, extra)
    dt, dj = _read_pair(tmp_path, "disp.nii.gz")
    _, aff = load_volume_nib_order(tmp_path / "t" / "disp.nii.gz")
    np.testing.assert_allclose(aff, _AFFINE, rtol=0, atol=1e-6)  # stored as float32
    assert dt.shape == (32, 32, 32, 3)
    diff = _absdiff(dt, dj)
    assert diff.mean() <= 1e-3 and diff.max() <= 2e-2
    med = np.median(dt[8:-8, 8:-8, 8:-8].reshape(-1, 3), axis=0)
    np.testing.assert_allclose(med, _SHIFT, atol=0.5)


def test_register_cli_multi_output_matches_jax(pair_files, tmp_path):
    """``--multi_iters``: the same file names; each file within the
    envelope of the single-output field (measured mean |diff| at most
    6.0e-5 voxels, max 2.6e-3; bounds 1e-3 and 2e-2); the (20, 0) file
    equal to the single-output field, bit for bit."""
    _both_register(pair_files, tmp_path, ["--multi_iters", "10,20", "--multi_smoothings", "0,3"])
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "disp_10_0.nii.gz", "disp_10_3.nii.gz", "disp_20_0.nii.gz", "disp_20_3.nii.gz"]
    for name in names:
        dt, dj = _read_pair(tmp_path, name)
        diff = _absdiff(dt, dj)
        assert diff.mean() <= 1e-3 and diff.max() <= 2e-2, name
    t_register.main(["-f", str(pair_files / "f.nii.gz"), "-m", str(pair_files / "m.nii.gz"),
                     *_SMALL, "--result_path", str(tmp_path / "single"), "--device", "cpu"])
    single, _ = load_volume_nib_order(tmp_path / "single" / "disp.nii.gz")
    multi, _ = load_volume_nib_order(tmp_path / "t" / "disp_20_0.nii.gz")
    np.testing.assert_array_equal(multi, single)


def test_register_cli_semantic_matches_jax(tmp_path):
    """``--semantic`` on label maps: the same field up to the one-hot
    argmin ties (measured max |diff| 6.5e-5 voxels on this pair; bound
    1e-3)."""
    seg = np.zeros((24, 24, 24), np.float32)
    seg[6:18, 5:17, 7:19] = 1
    seg[9:14, 8:13, 10:15] = 2
    save_volume_nib_order(seg, _AFFINE, tmp_path / "f.nii.gz")
    save_volume_nib_order(np.roll(seg, (2, -1, 1), axis=(0, 1, 2)), _AFFINE, tmp_path / "m.nii.gz")
    args = ["-f", str(tmp_path / "f.nii.gz"), "-m", str(tmp_path / "m.nii.gz"), "--semantic",
            "--grid_sp", "3", "--disp_hw", "2", "--selected_niter", "6", "--dtype", "float32"]
    t_register.main(args + ["--result_path", str(tmp_path / "t"), "--device", "cpu"])
    j_register.main(args + ["--result_path", str(tmp_path / "j")])
    dt, dj = _read_pair(tmp_path, "disp.nii.gz")
    assert _absdiff(dt, dj).max() <= 1e-3


def test_register_cli_sad_raises_naming_a4(pair_files, tmp_path):
    """``--cost_metric sad`` no longer raises: the MIND pair with the SAD
    cost (one box pass, as the OASIS recipe) against the JAX CLI.  The
    convex stages agree (argmins equal, tests/test_torch_streamed.py); the
    two packages' Adam loops then part from this init more than from the
    SSD one (ROADMAP, behaviours to know): measured mean |diff| 1.5e-3, p99
    0.025 and max 0.096 voxels, bounds 5e-3, 0.1 and 0.25; the shift
    recovered; the file-level function writes the same field."""
    _both_register(pair_files, tmp_path, ["--cost_metric", "sad", "--cost_smooth_passes", "1"])
    dt, dj = _read_pair(tmp_path, "disp.nii.gz")
    diff = _absdiff(dt, dj)
    assert diff.mean() <= 5e-3 and np.quantile(diff, 0.99) <= 0.1 and diff.max() <= 0.25, (
        diff.mean(), diff.max())
    med = np.median(dt[8:-8, 8:-8, 8:-8].reshape(-1, 3), axis=0)
    np.testing.assert_allclose(med, _SHIFT, atol=0.5)
    (tmp_path / "api").mkdir()
    out = t_register.convex_adam_from_files(
        pair_files / "f.nii.gz", pair_files / "m.nii.gz", grid_sp=4, disp_hw=2,
        selected_niter=20, dtype="float32", cost_metric="sad", cost_smooth_passes=1,
        result_path=tmp_path / "api", device="cpu")
    np.testing.assert_array_equal(load_volume_nib_order(out)[0], dt)


def test_clis_default_to_cuda(pair_files, tmp_path, monkeypatch):
    """Without ``--device`` a CLI runs on the card, and raises where there
    is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_register.main(["-f", str(pair_files / "f.nii.gz"), "-m", str(pair_files / "m.nii.gz"),
                         "--result_path", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_apply.main(["--input_field", str(pair_files / "f.nii.gz"), "--input_moving",
                      str(pair_files / "m.nii.gz"), "--output_warped", str(tmp_path / "w.nii.gz")])


def test_apply_cli_matches_jax(pair_files, tmp_path):
    """The same field file warps the moving image alike in both CLIs (the
    gather's corner weights multiply in another order: measured max |diff|
    4.6e-5 on values of about 100; bound 1e-4); the moving image's affine."""
    rng = np.random.default_rng(2)
    field = rng.uniform(-3, 3, (32, 32, 32, 3)).astype(np.float32)
    save_volume_nib_order(field, _AFFINE, tmp_path / "field.nii.gz")
    for pkg, name in ((t_apply, "t.nii.gz"), (j_apply, "j.nii.gz")):
        args = ["--input_field", str(tmp_path / "field.nii.gz"),
                "--input_moving", str(pair_files / "m.nii.gz"),
                "--output_warped", str(tmp_path / name)]
        pkg.main(args + (["--device", "cpu"] if pkg is t_apply else []))
    wt, at = load_volume_nib_order(tmp_path / "t.nii.gz")
    wj, aj = load_volume_nib_order(tmp_path / "j.nii.gz")
    np.testing.assert_array_equal(at, aj)
    np.testing.assert_allclose(at, _AFFINE, rtol=0, atol=1e-6)  # stored as float32
    assert _absdiff(wt, wj).max() <= 1e-4


def _translation_inputs(d):
    """A 24 x 24 x 20 image of 1.5 x 1.5 x 2 mm and its copy moved by
    (2, -1, 1) voxels, as MHA, with a co-moving image."""
    data = _volume((20, 24, 24), 4)
    spacing, origin = (1.5, 1.5, 2.0), (10.0, -20.0, 5.0)
    moved_origin = (origin[0] + 3.0, origin[1] - 1.5, origin[2] + 2.0)
    write_image(JImage(data, spacing, origin), d / "fixed.mha")
    write_image(JImage(data, spacing, moved_origin), d / "moving.mha")
    write_image(JImage(data * 0.5, spacing, moved_origin), d / "co.mha")
    return origin


def test_translation_cli_matches_jax(tmp_path, capsys):
    """Both CLIs print the same whole-voxel translation (the truth) and
    write the moved and co-moving images with the same origin and data."""
    _translation_inputs(tmp_path)
    for pkg, tag in ((t_translation, "t"), (j_translation, "j")):
        args = ["--fixed_path", str(tmp_path / "fixed.mha"),
                "--moving_path", str(tmp_path / "moving.mha"),
                "--moving_output_path", str(tmp_path / f"moved_{tag}.mha"),
                "--co_moving_paths", str(tmp_path / "co.mha"),
                "--co_moving_output_paths", str(tmp_path / f"co_{tag}.mha")]
        pkg.main(args + (["--device", "cpu"] if tag == "t" else []))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("translation")]
    assert len(lines) == 2 and lines[0] == lines[1] == "translation_xyz_mm: (3.0, -1.5, 2.0)"
    for name in ("moved", "co"):
        t, j = read_image(tmp_path / f"{name}_t.mha"), read_image(tmp_path / f"{name}_j.mha")
        np.testing.assert_array_equal(t.data, j.data)
        assert t.origin == j.origin and t.spacing == j.spacing


def test_translation_cli_checks_co_moving_counts_first(tmp_path, monkeypatch):
    """Mismatched co-moving counts stop the CLI before it registers."""
    import convexadam_torch.pipeline.translation as ttrans

    monkeypatch.setattr(ttrans, "convex_adam_translation",
                        lambda *a, **k: pytest.fail("registered before checking the counts"))
    with pytest.raises(SystemExit):
        t_translation.main(["--fixed_path", "a.mha", "--moving_path", "b.mha",
                            "--moving_output_path", "c.mha", "--co_moving_paths", "d.mha",
                            "e.mha", "--co_moving_output_paths", "f.mha", "--device", "cpu"])


@pytest.fixture(scope="module")
def sweep_config(tmp_path_factory):
    """The JAX package's sweep CLI fixture: three 32^3 subjects of two
    nested boxes."""
    root = tmp_path_factory.mktemp("sweepdata")
    rng = np.random.default_rng(0)
    shape = (32, 32, 32)
    for k in range(3):
        o = rng.integers(-2, 3, 3)
        seg = np.zeros(shape, np.float32)
        seg[8 + o[0]: 26 + o[0], 8 + o[1]: 24 + o[1], 8 + o[2]: 24 + o[2]] = 1
        seg[12 + o[0]: 20 + o[0], 12 + o[1]: 20 + o[1], 12 + o[2]: 20 + o[2]] = 2
        save_volume_nib_order(seg, np.eye(4), root / f"pred_{k}.nii.gz")
        save_volume_nib_order(seg, np.eye(4), root / f"gt_{k}.nii.gz")
    config = {
        "topk": [0, 1, 2], "topk_pair": [[0, 1], [1, 2]], "test": [0, 1, 2],
        "test_pair": [[0, 2]], "HWD": list(shape),
        "f_predict": str(root / "pred_%d.nii.gz"), "f_gt": str(root / "gt_%d.nii.gz"),
        "num_labels": 3, "output": str(root / "stage1.npz"),
        "output_adam": str(root / "stage2.npz"),
    }
    return root, config


def _config_file(root, config, out_dir, name):
    path = root / name
    path.write_text(json.dumps(dict(config, output_dir=str(out_dir))))
    return path


def test_sweep_cli_infer_matches_jax(sweep_config):
    """``infer``: the same file names and affine, the fields within float32
    rounding (measured max |diff| 3.3e-5 voxels; bound 1e-3);
    ``--setting_batch`` is accepted and changes nothing."""
    root, config = sweep_config
    args = ["--convex_s", "3", "--adam_s1", "0", "--adam_s2", "1"]
    t_sweep.main(["infer", str(_config_file(root, config, root / "t", "t.json")), *args,
                  "--setting_batch", "4", "--device", "cpu"])
    j_sweep.main(["infer", str(_config_file(root, config, root / "j", "j.json")), *args])
    out = pathlib.Path(root)
    assert sorted(p.name for p in (out / "t").iterdir()) == sorted(
        p.name for p in (out / "j").iterdir()) == ["disp_0_2.nii.gz"]
    dt, dj = _read_pair(out, "disp_0_2.nii.gz")
    assert dt.shape == (32, 32, 32, 3) and _absdiff(dt, dj).max() <= 1e-3


def test_sweep_cli_mesh_raises_naming_a9(sweep_config, monkeypatch, capsys):
    """``--mesh`` in one process (no process group: a 1 x 1 grid) with
    ``--setting_batch 2``: the arrays and messages of the run without it,
    ``times`` aside (it raised before the multi-device layer was ported;
    two ranks: ``tests/test_torch_parallel.py``)."""
    import convexadam_torch.selfconfig as tsc

    root, config = sweep_config
    three = tsc.stage1_settings()[:3]
    monkeypatch.setattr(tsc, "stage1_settings", lambda: three)
    got = {}
    for tag, extra in (("plain", []), ("mesh", ["--mesh", "--setting_batch", "2"])):
        cfg = dict(config, output=str(root / f"mesh_{tag}.npz"))
        path = _config_file(root, cfg, root / f"mesh_{tag}", f"mesh_{tag}.json")
        assert t_sweep.main(["convex", str(path), "--device", "cpu", *extra]) == 0
        got[tag] = (dict(np.load(cfg["output"])), capsys.readouterr().out)
    for k in ("dice", "jstd", "hd95", "rank"):
        np.testing.assert_array_equal(got["mesh"][0][k], got["plain"][0][k])
    assert got["mesh"][1] == got["plain"][1] and "best convex setting: s=" in got["mesh"][1]


def test_sweep_cli_needs_the_chosen_settings(sweep_config):
    root, config = sweep_config
    path = _config_file(root, config, root / "none", "none.json")
    with pytest.raises(SystemExit):
        t_sweep.main(["infer", str(path), "--device", "cpu"])
    with pytest.raises(SystemExit):
        t_sweep.main(["adam", str(path), "--device", "cpu"])


def test_sweep_cli_convex_resume_writes_the_jax_schema(sweep_config, monkeypatch, capsys):
    """``convex`` over three seeded settings (the list cut for time), then
    ``--resume`` from its checkpoint: the JAX CLI's ``.npz`` keys and
    messages, the same arrays, no setting run again."""
    import convexadam_torch.selfconfig as tsc
    import convexadam_torch.selfconfig.engine as teng

    root, config = sweep_config
    config = dict(config, output=str(root / "resume_stage1.npz"))
    path = _config_file(root, config, root / "resume", "resume.json")
    three = tsc.stage1_settings()[:3]
    monkeypatch.setattr(tsc, "stage1_settings", lambda: three)
    assert t_sweep.main(["convex", str(path), "--device", "cpu"]) == 0
    first = dict(np.load(config["output"]))
    assert set(first) == {"dice", "jstd", "hd95", "times", "rank"}
    out = capsys.readouterr().out
    assert "best convex setting: s=" in out and "jstd" in out
    monkeypatch.setattr(teng, "convex_field_semantic",
                        lambda *a, **k: pytest.fail("a completed setting ran again"))
    assert t_sweep.main(["convex", str(path), "--resume", "--device", "cpu"]) == 0
    again = dict(np.load(config["output"]))
    for k in ("dice", "jstd", "hd95", "rank"):
        np.testing.assert_array_equal(again[k], first[k])


def _small_l2r_task(root):
    """The JAX package's ``SynthTask`` layout at 24^3."""
    from scipy.ndimage import uniform_filter

    task = root / "Small"
    for sub in ("images", "labels"):
        (task / sub).mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(3):
        o = rng.integers(-2, 3, 3)
        seg = np.zeros((24, 24, 24), np.int32)
        seg[5 + o[0]: 19 + o[0], 5 + o[1]: 19 + o[1], 5 + o[2]: 19 + o[2]] = 1
        seg[9 + o[0]: 15 + o[0], 9 + o[1]: 15 + o[1], 9 + o[2]: 15 + o[2]] = 2
        vol = uniform_filter(rng.standard_normal(seg.shape).astype(np.float32), 2) * 30 + seg * 60
        save_volume_nib_order(vol, np.eye(4), task / "images" / f"c{i}.nii.gz")
        save_volume_nib_order(seg.astype(np.float32), np.eye(4), task / "labels" / f"c{i}.nii.gz")
    (task / "Small_dataset.json").write_text(json.dumps({
        "modality": {"0": "MR"}, "provided_data": {"0": ["image", "label"]},
        "registration_val": [{"fixed": "images/c0.nii.gz", "moving": "images/c1.nii.gz"}],
        "registration_test": [{"fixed": "images/c0.nii.gz", "moving": "images/c2.nii.gz"}]}))
    return task


def test_l2r_cli_against_jax_files(tmp_path, monkeypatch):
    """``cli.l2r`` end to end with one grid setting (the task's own six cut
    for time): a ``WINNER`` line, the validation files the JAX package's
    grid writes, and the test field the JAX package's ``run_testset`` of
    that winner writes, with the same affine."""
    import convexadam_torch.selfconfig.l2r as tl
    import convexadam_tpu.selfconfig.l2r as jl

    _small_l2r_task(tmp_path)
    grid = property(lambda self: ([4], [2], [1.0]))
    monkeypatch.setattr(tl.L2RTask, "grid_options", grid)
    monkeypatch.setattr(jl.L2RTask, "grid_options", grid)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_l2r.main(["--data_dir", str(tmp_path), "--task_name", "Small", "--output_dir",
                    str(tmp_path / "t"), "--device", "cpu"])
    winner = [ln for ln in buf.getvalue().splitlines() if ln.startswith("WINNER: ")]
    assert len(winner) == 1
    key = winner[0].split()[1]
    task = jl.L2RTask.load(tmp_path, "Small")
    results = jl.run_validation_grid(task, tmp_path / "j" / "validation", verbose=False)
    assert key in results
    assert sorted(p.name for p in (tmp_path / "t" / "validation").iterdir()) == sorted(
        p.name for p in (tmp_path / "j" / "validation").iterdir())
    written = jl.run_testset(task, key, tmp_path / "j" / "testset")
    assert [p.name for p in (tmp_path / "t" / "testset").iterdir()] == [p.name for p in written]
    dt, at = load_volume_nib_order(tmp_path / "t" / "testset" / written[0].name)
    _, aj = load_volume_nib_order(written[0])
    np.testing.assert_array_equal(at, aj)
    assert np.isfinite(dt).all()


def test_console_scripts_resolve():
    """The port's five console scripts resolve to its CLIs' ``main``."""
    scripts = tomllib.loads((_ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    for name in ("register", "apply", "translation", "sweep", "l2r"):
        target = scripts[f"convexadam-torch-{name}"]
        assert target == f"convexadam_torch.cli.{name}:main"
        mod, attr = target.split(":")
        assert callable(getattr(__import__(mod, fromlist=[attr]), attr))


# ---------------------------------------------------------------------------
# compat.py
# ---------------------------------------------------------------------------


def _compat_pair(shape=(24, 24, 24), shift=_SHIFT):
    vol = _volume(shape, 7)
    return vol, np.roll(vol, shift, axis=(0, 1, 2))


_KW = dict(grid_sp=4, disp_hw=2, selected_niter=6, grid_sp_adam=2)


@pytest.mark.parametrize("dtype", [None, torch.float32, "float32", torch.float16, torch.bfloat16,
                                   "bfloat16", "auto", torch.float64])
def test_map_dtype_matches_jax(dtype):
    assert tcompat._map_dtype(dtype) == jcompat._map_dtype(dtype)


def test_map_dtype_rejects_what_jax_rejects():
    for pkg in (tcompat, jcompat):
        with pytest.raises(ValueError):
            pkg._map_dtype(torch.int32)


def test_convex_adam_pt_matches_jax():
    """A float64 field, within float32 rounding of the JAX package's
    (measured max |diff| 5.7e-5 voxels; bound 1e-3); torch inputs give the
    same field as numpy ones."""
    vol, mov = _compat_pair()
    dt = tcompat.convex_adam_pt(vol, mov, dtype=torch.float32, device="cpu", **_KW)
    dj = jcompat.convex_adam_pt(vol, mov, dtype=torch.float32, **_KW)
    assert dt.dtype == np.float64 and dt.shape == (24, 24, 24, 3)
    assert _absdiff(dt, dj).max() <= 1e-3
    dtt = tcompat.convex_adam_pt(torch.from_numpy(vol), torch.from_numpy(mov),
                                 dtype=torch.float16, device="cpu", **_KW)
    np.testing.assert_array_equal(dtt, dt)  # float16 is "auto": float32 on the CPU


def test_convex_adam_pt_use_mask_matches_jax(tmp_path):
    """Masks from files (as the reference) and in memory, the moving one
    moved with the image: the port's infill equals the JAX package's, so
    the fields agree as unmasked ones do (measured max |diff| 6.2e-5
    voxels; bound 1e-3)."""
    vol, mov = _compat_pair()
    mask = np.zeros(vol.shape, np.float32)
    mask[4:20, 4:20, 4:20] = 1.0
    save_volume_nib_order(mask, np.eye(4), tmp_path / "mask.nii.gz")
    kw = dict(_KW, use_mask=True, path_fixed_mask=tmp_path / "mask.nii.gz", dtype="float32")
    mask_m = np.roll(mask, _SHIFT, axis=(0, 1, 2))
    dt = tcompat.convex_adam_pt(vol, mov, path_moving_mask=mask_m, device="cpu", **kw)
    dj = jcompat.convex_adam_pt(vol, mov, path_moving_mask=mask_m, **kw)
    assert _absdiff(dt, dj).max() <= 1e-3
    plain = tcompat.convex_adam_pt(vol, mov, dtype="float32", device="cpu", **_KW)
    assert np.abs(dt - plain).max() > 0


def test_convex_adam_file_to_file_matches_jax(tmp_path):
    """``disp.nii.gz`` as the reference writes it: float64 on disk (NIfTI
    datatype 64), the fixed image's affine."""
    vol, mov = _compat_pair()
    affine = np.diag([1.0, 1.0, 2.0, 1.0])
    save_volume_nib_order(vol, affine, tmp_path / "f.nii.gz")
    save_volume_nib_order(mov, affine, tmp_path / "m.nii.gz")
    tcompat.convex_adam(tmp_path / "f.nii.gz", tmp_path / "m.nii.gz", result_path=tmp_path / "t",
                        device="cpu", **_KW)
    jcompat.convex_adam(tmp_path / "f.nii.gz", tmp_path / "m.nii.gz", result_path=tmp_path / "j",
                        **_KW)
    dt, dj = _read_pair(tmp_path, "disp.nii.gz")
    raw = gzip.decompress((tmp_path / "t" / "disp.nii.gz").read_bytes())
    assert struct.unpack_from("<h", raw, 70)[0] == 64
    _, aff = load_volume_nib_order(tmp_path / "t" / "disp.nii.gz")
    np.testing.assert_array_equal(aff, affine)
    assert _absdiff(dt, dj).max() <= 1e-3  # as test_convex_adam_pt_matches_jax


def test_apply_convex_compat_matches_jax():
    """Torch inputs, as the reference's ``apply_convex`` takes them (bound
    1e-4, as the CLI's)."""
    vol, mov = _compat_pair()
    disp = np.zeros((24, 24, 24, 3), np.float32)
    disp[..., 0] = 2.0
    wt = tcompat.apply_convex(torch.from_numpy(disp), torch.from_numpy(mov), device="cpu")
    wj = jcompat.apply_convex(torch.from_numpy(disp), torch.from_numpy(mov))
    assert _absdiff(wt, wj).max() <= 1e-4
    np.testing.assert_allclose(wt[4:-4, 4:-4, 4:-4], np.roll(mov, -2, axis=0)[4:-4, 4:-4, 4:-4],
                               atol=1e-3)


def test_convex_adam_translation_compat_matches_jax():
    """``MedicalImage`` in and out; the same whole-voxel translation as the
    JAX package's."""
    vol, mov = _compat_pair((28, 28, 28), (2, 0, 0))
    t_t, moved_t, _ = tcompat.convex_adam_translation(TImage(vol), TImage(mov), device="cpu")
    t_j, moved_j, _ = jcompat.convex_adam_translation(JImage(vol), JImage(mov))
    assert isinstance(moved_t, TImage)
    assert tuple(t_t) == tuple(t_j)
    assert moved_t.origin == moved_j.origin


def test_even_selected_smooth_rounds_up():
    """The documented divergence kept: an even ``selected_smooth`` gives
    exactly the next odd one's field."""
    vol, mov = _compat_pair()
    kw = dict(grid_sp=3, disp_hw=2, selected_niter=4, device="cpu")
    even = tcompat.convex_adam_pt(vol, mov, selected_smooth=4, **kw)
    odd = tcompat.convex_adam_pt(vol, mov, selected_smooth=5, **kw)
    np.testing.assert_array_equal(even, odd)
    assert np.abs(even - tcompat.convex_adam_pt(vol, mov, selected_smooth=0, **kw)).max() > 0
