"""The port's metrics, label warp and Learn2Reg evaluator against the JAX
package, on the CPU.  Inputs are made from a seed with numpy and handed to
both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import uniform_filter

from convexadam_torch import evaluate_field
from convexadam_torch.core import metrics as tm
from convexadam_torch.core.features import label_counts
from convexadam_torch.core.warp import grid_sample_3d, warp_with_displacement
from convexadam_torch.kernels import LAUNCHES

torch.set_num_threads(2)


def _labels(seed, shape, n_labels):
    v = uniform_filter(np.random.default_rng(seed).standard_normal(shape).astype(np.float32), 5)
    qs = np.linspace(0, 1, n_labels + 2)[1:-1]
    return np.digitize(v, np.quantile(v, qs)).astype(np.int32)


def _smooth_field(rng, shape, amp):
    f = rng.standard_normal((3,) + shape).astype(np.float32)
    f = np.stack([uniform_filter(c, 5) for c in f])
    return (f / np.abs(f).max() * amp).astype(np.float32)


def test_label_counts_matches_jax(rng):
    from convexadam_tpu.core.features import label_counts as jax_label_counts

    seg = rng.integers(-1, 7, (9, 10, 11)).astype(np.int32)
    np.testing.assert_array_equal(
        label_counts(torch.from_numpy(seg), 5).numpy(), np.asarray(jax_label_counts(jnp.asarray(seg), 5))
    )


def test_dice_matches_jax(rng):
    from convexadam_tpu.core.metrics import dice_coeff

    a = rng.integers(0, 5, (12, 13, 14)).astype(np.int32)
    b = np.where(rng.random(a.shape) < 0.7, a, rng.integers(0, 5, a.shape)).astype(np.int32)
    got = tm.dice_coeff(torch.from_numpy(a), torch.from_numpy(b), 5).numpy()
    np.testing.assert_allclose(got, np.asarray(dice_coeff(jnp.asarray(a), jnp.asarray(b), 5)),
                               rtol=1e-5)


@pytest.mark.parametrize("normalized", [False, True])
def test_jacobian_metrics_match_jax(rng, normalized):
    from convexadam_tpu.core import metrics as jm

    amp = 0.3 if normalized else 3.0
    disp = _smooth_field(rng, (14, 15, 16), amp)
    jd = jnp.asarray(disp)
    td = torch.from_numpy(disp)
    det = tm.jacobian_determinant(td, normalized=normalized).numpy()
    ref = np.asarray(jm.jacobian_determinant(jd, normalized=normalized))
    assert det.shape == ref.shape == (10, 11, 12)
    # the same products and differences; XLA may fuse them: rtol 1e-5
    np.testing.assert_allclose(det, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tm.sd_log_jacobian(td, normalized)),
                               float(jm.sd_log_jacobian(jd, normalized)), rtol=1e-5)
    np.testing.assert_allclose(float(tm.negative_jacobian_fraction(td, normalized)),
                               float(jm.negative_jacobian_fraction(jd, normalized)), rtol=1e-5)


@pytest.mark.parametrize("spacing", [None, (1.5, 0.8, 2.0)])
def test_keypoint_tre_matches_jax(rng, spacing):
    from convexadam_tpu.core.metrics import keypoint_tre

    disp = _smooth_field(rng, (12, 14, 16), 2.0)
    kf = (rng.random((25, 3)) * np.array([11, 13, 15])).astype(np.float32)
    km = (kf + rng.standard_normal((25, 3))).astype(np.float32)
    sp = None if spacing is None else np.asarray(spacing, np.float32)
    ref = np.asarray(keypoint_tre(jnp.asarray(disp), jnp.asarray(kf), jnp.asarray(km),
                                  None if sp is None else jnp.asarray(sp)))
    got = tm.keypoint_tre(torch.from_numpy(disp), torch.from_numpy(kf), torch.from_numpy(km),
                          None if sp is None else torch.from_numpy(sp)).numpy()
    # F.grid_sample's trilinear weights against the JAX sampler's: rtol 1e-5
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_host_hd95_matches_jax():
    from convexadam_tpu.core.metrics import hd95

    a, b = _labels(0, (16, 18, 20), 4), _labels(1, (16, 18, 20), 4)
    b[b == 4] = 3
    got = tm.hd95(a, b, 4)
    assert got[3] == 30.0
    # scipy's float64 EDT against the JAX package's (native float32 or scipy)
    np.testing.assert_allclose(got, hd95(a, b, 4), atol=1e-5)


def test_rank_helpers_match_jax(rng):
    from convexadam_tpu.core.metrics import rank_product, sort_rank

    v = [rng.random(9), rng.random(9)]
    np.testing.assert_array_equal(tm.sort_rank(v[0]), sort_rank(v[0]))
    ranks = [sort_rank(x) for x in v]
    np.testing.assert_array_equal(tm.rank_product(ranks), rank_product(ranks))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_matches_jax(rng, mode, padding_mode, align_corners):
    from convexadam_tpu.core.warp import grid_sample_3d as jax_grid_sample_3d

    vol = rng.standard_normal((2, 6, 7, 8)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (5, 7, 3)).astype(np.float32)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode, mode=mode)
    ref = np.asarray(jax_grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid), **kw))
    got = grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(grid), **kw).numpy()
    assert got.shape == ref.shape == (2, 5, 7)
    if mode == "nearest":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_nearest_label_warp_matches_jax(rng):
    """The label warp of the evaluator: equal labels.  The grid is built and
    unnormalized in the JAX package's operation order and both packages run
    it op by op (no fused multiply-add), so no half-voxel tie rounds the
    other way; a field of whole and half voxels puts many points on ties."""
    from convexadam_tpu.core.warp import warp_with_displacement as jax_warp

    seg = _labels(4, (20, 22, 24), 5).astype(np.float32)
    disp = (np.round(_smooth_field(rng, seg.shape, 4.0) * 2) / 2).astype(np.float32)
    disp[0, ::3] = 0.5
    ref = np.asarray(jax_warp(jnp.asarray(seg)[None], jnp.asarray(disp), mode="nearest"))
    got = warp_with_displacement(torch.from_numpy(seg)[None], torch.from_numpy(disp),
                                 mode="nearest").numpy()
    np.testing.assert_array_equal(got, ref)


def _case(seed=0, shape=(32, 30, 28), n_labels=4):
    rng = np.random.default_rng(seed)
    seg_f = _labels(seed + 10, shape, n_labels)
    seg_m = np.roll(seg_f, (2, -1, 1), axis=(0, 1, 2))
    # a smooth shift plus voxel noise, which folds the field in places
    disp = (_smooth_field(rng, shape, 2.5) + 0.6 * rng.standard_normal((3,) + shape)
            + np.array([2.0, -1.0, 1.0])[:, None, None, None]).astype(np.float32)
    disp = np.moveaxis(disp, 0, -1).copy()
    kf = (rng.random((12, 3)) * (np.array(shape) - 1)).astype(np.float32)
    km = (kf + rng.standard_normal((12, 3))).astype(np.float32)
    return disp, seg_f, seg_m, kf, km


def test_evaluate_field_matches_jax():
    """Every key of the JAX evaluator, at 32x30x28 with 4 labels and 12
    keypoints.  The JAX package scores HD95 on its host EDT loop off the TPU;
    the port uses its device engine on any device, and the numbers agree."""
    from convexadam_tpu.selfconfig.l2r import evaluate_field as jax_evaluate_field

    disp, seg_f, seg_m, kf, km = _case()
    spacing = np.array([1.2, 1.0, 0.8], np.float32)
    ref = jax_evaluate_field(disp, seg_f, seg_m, 4, kf, km, spacing)
    got = evaluate_field(disp, seg_f, seg_m, 4, kf, km, spacing, device="cpu")
    assert set(got) == set(ref) == {
        "sdlogj", "neg_jac_frac", "dice", "dice30", "hd95", "tre", "tre30"
    }
    # sums in another order (numpy float32 std, float32 means): rtol 1e-5
    for key in ("sdlogj", "neg_jac_frac", "dice", "dice30", "tre", "tre30"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(got["hd95"], ref["hd95"], atol=1e-5)
    assert 0.0 < got["neg_jac_frac"] < 1.0 and got["hd95"].shape == (4,)


def test_evaluate_field_host_fallback_beyond_extent(monkeypatch):
    """Beyond the engine's extent limit the host EDT loop scores HD95, with
    the same numbers."""
    import convexadam_torch.selfconfig.l2r as l2r

    disp, seg_f, seg_m, _, _ = _case(1, (20, 18, 16), 3)
    dev = evaluate_field(disp, seg_f, seg_m, 3, device="cpu")
    monkeypatch.setattr(l2r, "MAX_PACKED_EXTENT", 8)
    host = evaluate_field(disp, seg_f, seg_m, 3, device="cpu")
    np.testing.assert_allclose(dev["hd95"], host["hd95"], atol=1e-5)
    assert host["hd95"].dtype == np.float64 and dev["hd95"].dtype == np.float32


def test_evaluate_field_beyond_extent_raises_on_the_card(monkeypatch):
    """On the card HD95 beyond the engine's extent limit raises before any
    work: nothing moves to the host EDT loop."""
    import convexadam_torch.selfconfig.l2r as l2r

    disp, seg_f, seg_m, _, _ = _case(1, (20, 18, 16), 3)
    monkeypatch.setattr(l2r, "MAX_PACKED_EXTENT", 8)
    monkeypatch.setattr(l2r, "_resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="extents <= 8"):
        evaluate_field(disp, seg_f, seg_m, 3)
    # without HD95 the limit does not apply
    monkeypatch.setattr(l2r, "_resolve_device", lambda device: torch.device("cpu"))
    out = evaluate_field(disp, seg_f, seg_m, 3, compute_hd95=False)
    assert "hd95" not in out and out["dice"].shape == (3,)


def test_evaluate_field_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_field(np.zeros((8, 8, 8, 3), np.float32))


def test_evaluate_field_on_cpu_launches_nothing():
    before = dict(LAUNCHES)
    disp, seg_f, seg_m, kf, km = _case(2, (16, 16, 16), 2)
    out = evaluate_field(disp, seg_f, seg_m, 2, kf, km, device="cpu")
    assert np.isfinite(out["hd95"]).all() and LAUNCHES == before
