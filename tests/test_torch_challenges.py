"""The port's Learn2Reg challenge recipes (``convexadam_torch.pipeline.
challenges``) against the JAX package's, on the cases of
``tests/test_challenges.py`` at 48^3, run on the CPU.

Each entry gets the same numpy inputs in both packages.  The MIND recipes
are held by their fields; task 3's one-hot features have argmin ties that
the packages break differently, so its fields are held by the Dice of the
labels they warp (as ``tests/test_torch_l2r.py`` holds one-hot arms).  The
tolerance of each assert is written beside it with the value measured.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

import convexadam_tpu.pipeline.challenges as jc
import convexadam_torch.pipeline.challenges as tc
from convexadam_tpu.core.features import semantic_template_weights as j_template_weights
from convexadam_tpu.pipeline.convex_adam import ConvexAdamConfig as JConfig
from convexadam_torch.core.features import semantic_template_weights
from convexadam_torch.core.metrics import dice_coeff
from convexadam_torch.core.warp import warp_with_displacement
from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

torch.set_num_threads(2)

SHAPE = (48, 48, 48)


def _smooth_volume(shape, seed=0, scale=100.0):
    rng = np.random.default_rng(seed)
    return uniform_filter(rng.standard_normal(shape).astype(np.float32), 2) * scale


def _label_volume(shape, seed):
    rng = np.random.default_rng(seed)
    v = uniform_filter(rng.standard_normal(shape).astype(np.float32), 6)
    return np.digitize(v, np.quantile(v, [0.25, 0.5, 0.75])).astype(np.int32)


def _frac_within(disp, shift, c):
    err = np.abs(disp[c:-c, c:-c, c:-c] - np.array(shift, np.float32))
    return float(np.mean(np.all(err < 1.0, axis=-1)))


TASK1_KW = dict(mind_r=1, mind_d=2, lambda_weight=0.6, grid_sp=4, disp_hw=4,
                selected_niter=40, grid_sp_adam=3, ic=True)


@pytest.fixture(scope="module")
def task1_case():
    vol = _smooth_volume(SHAPE)
    shift = (3, -2, 2)
    mask = np.zeros(SHAPE, np.float32)
    mask[8:-8, 8:-8, 8:-8] = 1.0
    return vol, np.roll(vol, shift, axis=(0, 1, 2)), mask, shift


def test_register_tps_densified_matches_jax(task1_case):
    """Task 1 on the JAX test's case (512 control points): measured max
    |diff| 9.6e-5 voxels, bound 1e-3; the shift recovered as the JAX test
    asks (> 90% of the central voxels within 1 voxel)."""
    vol, moving, mask, shift = task1_case
    ref = jc.register_tps_densified(vol, moving, mask, num_samples=512, tps_step=4,
                                    cfg=JConfig(**TASK1_KW))
    out = tc.register_tps_densified(vol, moving, mask, num_samples=512, tps_step=4,
                                    cfg=ConvexAdamConfig(**TASK1_KW), device="cpu")
    assert out.shape == SHAPE + (3,) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    assert _frac_within(out, shift, 12) > 0.9


def test_register_tps_densified_is_the_registration_densified(task1_case):
    """The recipe is ``convex_adam`` composed with the densification, to
    the bit, and its default configuration is task 1's (disp_hw 8)."""
    vol, moving, mask, _ = task1_case
    cfg = ConvexAdamConfig(**TASK1_KW)
    out = tc.register_tps_densified(vol, moving, mask, num_samples=256, cfg=cfg, device="cpu")
    disp = convex_adam(vol, moving, cfg, device="cpu")
    composed = tc._tps_densify(disp, mask, 256, 4, True, 0, torch.device("cpu"))
    np.testing.assert_array_equal(out, composed)
    assert tc.TASK1_CONFIG.disp_hw == 8 and tc.TASK1_CONFIG.grid_sp == 4
    assert tc.TASK1_CONFIG.grid_sp_adam == 3 and tc.TASK1_CONFIG.selected_niter == 40


@pytest.mark.parametrize("flip", ["xy", "z", ""])
def test_task1_field_to_original_matches_jax(rng, flip):
    """A random preprocessed field to a 64 x 70 x 60 original grid with
    crops and anisotropic spacings: measured max |diff| at most 2.4e-6
    voxels, bound 1e-4."""
    meta = jc.Task1CaseMeta(
        fix_shape=(64, 70, 60), fix_spacing=(1.0, 0.9, 1.2),
        fix_crop=((2.0, 3.0, 1.0), (62.0, 67.0, 57.0)),
        mov_shape=(66, 68, 62), mov_spacing=(1.1, 0.9, 1.0),
        mov_crop=((1.0, 2.0, 3.0), (63.0, 66.0, 59.0)), flip=flip,
    )
    field = (rng.standard_normal((30, 32, 34, 3)) * 2.0).astype(np.float32)
    sp_f = np.array([2.0, 1.8, 2.1], np.float32)
    sp_m = np.array([2.1, 1.9, 2.0], np.float32)
    ref = jc.task1_field_to_original(field, sp_f, sp_m, meta)
    out = tc.task1_field_to_original(field, sp_f, sp_m,
                                     tc.Task1CaseMeta(**dataclasses.asdict(meta)), device="cpu")
    assert out.shape == ref.shape == (3, 32, 35, 30)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_task2_case_matches_jax():
    """Task 2 on the JAX test's lung case: the two packages' Adam loops
    part after some iterations (ROADMAP, behaviours to know), measured mean
    |diff| 0.018 and p99 0.15 voxels, bounds 0.05 and 0.5 (as
    tests/test_torch_l2r.py holds the L2R fields); the shift recovered."""
    vol = _smooth_volume(SHAPE, seed=3)
    shift = (4, -3, 2)
    moving = np.roll(vol, shift, axis=(0, 1, 2))
    mask = np.zeros(SHAPE, np.float32)
    mask[6:-6, 6:-6, 6:-6] = 1.0
    mask_m = np.roll(mask, shift, axis=(0, 1, 2))
    ref = jc.task2_case(vol, moving, mask, mask_m)
    out = tc.task2_case(vol, moving, mask, mask_m, device="cpu")
    assert out["disp"].shape == SHAPE + (3,) and out["disp_half"].shape == (3, 24, 24, 24)
    for key in ("disp", "disp_half"):
        diff = np.abs(out[key] - ref[key])
        assert diff.mean() <= 0.05 and np.quantile(diff, 0.99) <= 0.5, (key, diff.mean())
    assert _frac_within(out["disp"], shift, 14) > 0.9
    assert tc.TASK2_CONFIG.cost_smooth_passes == 1 and not tc.TASK2_CONFIG.ic


def _label_dice(seg_f, seg_m, disp, num_labels):
    warped = warp_with_displacement(
        torch.from_numpy(seg_m).float()[None], torch.from_numpy(np.moveaxis(disp, -1, 0).copy()),
        mode="nearest",
    )[0].round().long()
    return dice_coeff(warped, torch.from_numpy(seg_f).long(), num_labels).numpy()


@pytest.mark.parametrize("template", [False, True])
def test_task3_case_matches_jax(template):
    """Task 3 (SAD, one box pass, double Adam smoothing) on the JAX test's
    label case, with per-pair and with frozen template weights: the Dice of
    the labels each field warps agrees within 2e-2 (one-hot argmin ties,
    the fields differ by about 0.1 voxels on average), and the shift is
    recovered as the JAX test asks (> 80% within 1 voxel, median error under
    0.5 voxels per axis)."""
    seg = _label_volume(SHAPE, seed=5)
    shift = (2, -3, 1)
    seg_m = np.roll(seg, shift, axis=(0, 1, 2))
    weights_t = weights_j = None
    if template:
        weights_j = np.asarray(j_template_weights(seg, seg_m, 4))
        weights_t = semantic_template_weights(torch.from_numpy(seg), torch.from_numpy(seg_m),
                                              4).numpy()
        np.testing.assert_allclose(weights_t, weights_j, rtol=1e-6)
    ref = jc.task3_case(seg, seg_m, num_labels=4, template_weights=weights_j)
    out = tc.task3_case(seg, seg_m, num_labels=4, template_weights=weights_t, device="cpu")
    assert out["disp"].shape == SHAPE + (3,) and out["disp_half"].shape == (3, 24, 24, 24)
    dice_t = _label_dice(seg, seg_m, out["disp"], 4)
    dice_j = _label_dice(seg, seg_m, ref["disp"], 4)
    assert np.abs(dice_t - dice_j).max() <= 2e-2, (dice_t, dice_j)
    c = 10
    err = out["disp"][c:-c, c:-c, c:-c] - np.array(shift, np.float32)
    assert _frac_within(out["disp"], shift, c) > 0.8
    assert np.all(np.abs(np.median(err.reshape(-1, 3), axis=0)) < 0.5)
    assert tc.TASK3_CONFIG.cost_metric == "sad"


def test_landmark_centroids_matches_jax():
    seg = np.zeros((10, 10, 10), np.int32)
    seg[2:4, 2:4, 2:4] = 1
    seg[7, 8, 9] = 2
    out = tc.landmark_centroids(seg, 3)
    np.testing.assert_array_equal(out, jc.landmark_centroids(seg, 3))
    np.testing.assert_allclose(out[0], [2.5, 2.5, 2.5])
    assert np.isnan(out[2]).all()


def test_curious_case_matches_jax():
    """CuRIOUS on the JAX test's translated case: the deformable field
    within 1e-4 voxels (measured 9.5e-7), so the identity and deformable
    TREs agree within 1e-4; the rigid fit draws other samples (a torch
    generator), so its TRE is held to the JAX test's bar (below 0.45 of the
    identity TRE) in both packages."""
    rng = np.random.default_rng(1)
    base = np.zeros(SHAPE, np.float32)
    base[6:-6, 6:-6, 6:-6] = _smooth_volume((36, 36, 36), seed=2, scale=50.0) + 100.0
    shift = (3, -2, 2)
    t1 = np.roll(base, shift, axis=(0, 1, 2))
    flair = np.roll(base * 0.8, shift, axis=(0, 1, 2))
    seg_f = np.zeros(SHAPE, np.int32)
    seg_m = np.zeros(SHAPE, np.int32)
    for i, p in enumerate(rng.integers(14, 34, (5, 3)), start=1):
        seg_f[p[0] - 1:p[0] + 2, p[1] - 1:p[1] + 2, p[2] - 1:p[2] + 2] = i
        q = p + np.array(shift)
        seg_m[q[0] - 1:q[0] + 2, q[1] - 1:q[1] + 2, q[2] - 1:q[2] + 2] = i
    kw = dict(grid_sp=4, disp_hw=3, mind_r=1, mind_d=2, mask_threshold=10.0, rigid_samples=1024)
    ref = jc.curious_case(base, t1, flair, seg_f, seg_m, **kw)
    out = tc.curious_case(base, t1, flair, seg_f, seg_m, device="cpu", **kw)
    assert out["disp"].shape == SHAPE + (3,) and out["rigid"].shape == (4, 4)
    np.testing.assert_allclose(out["disp"], ref["disp"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["tre0"], ref["tre0"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["tre_def"], ref["tre_def"], rtol=0, atol=1e-4)
    tre0 = np.nanmean(out["tre0"])
    assert abs(tre0 - np.sqrt(sum(s**2 for s in shift))) < 0.5
    assert np.nanmean(out["tre_def"]) < 0.45 * tre0
    assert np.nanmean(out["tre_rigid"]) < 0.45 * tre0
    assert np.nanmean(ref["tre_rigid"]) < 0.45 * np.nanmean(ref["tre0"])


def test_challenge_entries_default_to_cuda(monkeypatch):
    """Without ``device`` every recipe runs on the card and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((8, 8, 8), np.float32)
    zi = np.zeros((8, 8, 8), np.int32)
    meta = tc.Task1CaseMeta((8, 8, 8), (1.0,) * 3, ((0.0,) * 3, (8.0,) * 3), (8, 8, 8),
                            (1.0,) * 3, ((0.0,) * 3, (8.0,) * 3))
    calls = [
        lambda: tc.register_tps_densified(z, z, z),
        lambda: tc.task1_field_to_original(np.zeros((8, 8, 8, 3), np.float32),
                                           np.ones(3, np.float32), np.ones(3, np.float32), meta),
        lambda: tc.task2_case(z, z, z, z),
        lambda: tc.task3_case(zi, zi, 2),
        lambda: tc.curious_case(z, z, z, zi, zi),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
