"""The port's rigid fitting, thin-plate splines, 3-D SSIM and jump-flooding
distance map against the JAX package, on the CPU.

Identical numpy inputs, made from a seed, go to both packages; the
tolerance of each assert is written beside it with the value measured.
``rigid_from_field`` draws its samples from a torch generator, not
``jax.random``, so it is held to a known rigid field instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convexadam_tpu.core import edt as jedt
from convexadam_tpu.core import metrics as jmetrics
from convexadam_tpu.core import rigid as jrigid
from convexadam_torch.core import edt as tedt
from convexadam_torch.core import metrics as tmetrics
from convexadam_torch.core import rigid as trigid

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rotation(rng):
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


def _rotation_about(axis, angle):
    """A proper rotation by ``angle`` radians about ``axis`` (Rodrigues)."""
    k = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def test_find_rigid_3d_matches_jax(rng):
    """Kabsch on identical (N, 3) points: measured max |diff| 2.7e-7, bound
    1e-5; and a transform recovered exactly up to float32."""
    x = rng.standard_normal((20, 3)).astype(np.float32)
    y = (rng.standard_normal((20, 3)) * 2).astype(np.float32)
    ref = np.asarray(jrigid.find_rigid_3d(jnp.asarray(x), jnp.asarray(y)))
    out = trigid.find_rigid_3d(_t(x), _t(y))
    assert out.dtype == torch.float32 and out.shape == (4, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    R, t = _rotation(rng), rng.standard_normal(3) * 5
    xs = (rng.standard_normal((30, 3)) * 10).astype(np.float32)
    ys = (xs @ R.T + t).astype(np.float32)
    T = trigid.find_rigid_3d(_t(xs), _t(ys)).numpy()
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-4)
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-3)


def test_least_trimmed_rigid_matches_jax(rng):
    """A quarter of the correspondences corrupted: both packages keep the
    same half and agree to 7.2e-7 (measured), bound 1e-5; the fit recovers
    the true transform."""
    R, t = _rotation(rng), rng.standard_normal(3) * 5
    x = (rng.standard_normal((60, 3)) * 10).astype(np.float32)
    y = (x @ R.T + t).astype(np.float32)
    y[:15] += (rng.standard_normal((15, 3)) * 40).astype(np.float32)
    xh = np.concatenate([x, np.ones((60, 1), np.float32)], 1)
    yh = np.concatenate([y, np.ones((60, 1), np.float32)], 1)
    ref = np.asarray(jrigid.least_trimmed_rigid(jnp.asarray(xh), jnp.asarray(yh)))
    out = trigid.least_trimmed_rigid(_t(xh), _t(yh)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[:3, :3], R, atol=1e-3)
    np.testing.assert_allclose(out[:3, 3], t, atol=1e-2)


def test_tps_fit_and_eval_match_jax(rng):
    """The TPS coefficients of 12 control points (measured 2.3e-6 of
    entries up to 4.9, bound 1e-5 relative to the largest), its values at 50
    points (measured 6.9e-6, bound 2e-5), and interpolation of the control
    values."""
    c = rng.standard_normal((12, 3)).astype(np.float32)
    f = rng.standard_normal((12, 3)).astype(np.float32)
    ref = np.asarray(jrigid.tps_fit(jnp.asarray(c), jnp.asarray(f)))
    theta = trigid.tps_fit(_t(c), _t(f))
    np.testing.assert_allclose(theta.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    x = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    ref_v = np.asarray(jrigid.tps_eval(jnp.asarray(x), jnp.asarray(c), jnp.asarray(ref)))
    out_v = trigid.tps_eval(_t(x), _t(c), _t(np.array(ref))).numpy()
    np.testing.assert_allclose(out_v, ref_v, rtol=0, atol=2e-5)
    np.testing.assert_allclose(trigid.tps_eval(_t(c), _t(c), theta).numpy(), f, atol=1e-3)


def test_thin_plate_dense_matches_jax(rng):
    """The dense field of 10 control displacements on an 18 x 16 x 14 grid
    at step 2: measured 1.4e-6 of values up to 0.59, bound 1e-5."""
    c = rng.uniform(-0.8, 0.8, (10, 3)).astype(np.float32)
    f = (rng.standard_normal((10, 3)) * 0.1).astype(np.float32)
    ref = np.asarray(jrigid.thin_plate_dense(jnp.asarray(c), jnp.asarray(f), shape=(18, 16, 14),
                                             step=2))
    out = trigid.thin_plate_dense(_t(c), _t(f), (18, 16, 14), 2).numpy()
    assert out.shape == (18, 16, 14, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_rigid_from_field_recovers_a_rigid_field(rng, masked):
    """The field of a known rotation (6 degrees) and translation, sampled
    uniformly or inside a box mask: the rotation within 1e-4 and the
    translation within 1e-3 voxels (exact correspondences, float32 fit)."""
    H, W, D = 24, 20, 22
    R = _rotation_about((1.0, 2.0, -0.5), np.deg2rad(6.0))
    t = np.array([2.0, -1.0, 3.0])
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float64) for s in (H, W, D)],
                                indexing="ij"), -1)
    disp = np.moveaxis(grid @ R.T + t - grid, -1, 0).astype(np.float32)
    mask = None
    if masked:
        mask = np.zeros((H, W, D), bool)
        mask[4:18, 3:15, 5:19] = True
    T = trigid.rigid_from_field(_t(disp), mask=None if mask is None else _t(mask),
                                num_samples=512, seed=3)
    assert T.shape == (4, 4) and T.dtype == torch.float32
    T = T.numpy()
    np.testing.assert_allclose(T[:3, :3], R, atol=1e-4)
    np.testing.assert_allclose(T[:3, 3], t, atol=1e-3)
    assert np.all(T[3] == [0, 0, 0, 1])


def test_rigid_from_field_samples_inside_the_mask():
    """Under a mask every drawn voxel lies inside it: a field that is rigid
    inside a box and wild outside gives the box's transform."""
    H, W, D = 16, 16, 16
    disp = np.random.default_rng(0).standard_normal((3, H, W, D)).astype(np.float32) * 5
    mask = np.zeros((H, W, D), bool)
    mask[5:12, 4:11, 6:13] = True
    disp[:, mask] = np.array([1.5, -2.0, 0.5], np.float32)[:, None]
    T = trigid.rigid_from_field(_t(disp), mask=_t(mask), num_samples=256).numpy()
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=1e-5)
    np.testing.assert_allclose(T[:3, 3], [1.5, -2.0, 0.5], atol=1e-4)


def test_f32_matmuls_restores_the_callers_settings():
    """The rigid functions switch TF32 off for the call and leave the
    caller's global settings as they found them."""
    prec, cudnn = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    seen = []

    @trigid._f32_matmuls
    def probe():
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))

    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        probe()
        assert seen == [("highest", False)]
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = cudnn


@pytest.mark.parametrize("noise", [0.1, 0.3, 1.0])
def test_ssim3d_matches_jax(rng, noise):
    """Mean 3-D SSIM of a volume and a noisy copy: measured |diff| below
    1e-6 (separable sums against XLA's convolutions), bound 1e-5."""
    v1 = rng.standard_normal((20, 22, 18)).astype(np.float32)
    v2 = v1 + noise * rng.standard_normal((20, 22, 18)).astype(np.float32)
    ref = float(jmetrics.ssim3d(jnp.asarray(v1), jnp.asarray(v2)))
    out = tmetrics.ssim3d(_t(v1), _t(v2))
    assert out.dtype == torch.float32 and out.ndim == 0
    assert abs(float(out) - ref) <= 1e-5
    assert abs(float(tmetrics.ssim3d(_t(v1), _t(v1))) - 1.0) <= 1e-5


@pytest.mark.parametrize("shape,density", [((17, 20, 13), 0.03), ((9, 31, 12), 0.005)])
def test_jump_flood_sqdist_matches_jax(rng, shape, density):
    """Squared distances as exact int32 integers, equal to the JAX
    package's, a seedless batch slice included (2^30)."""
    seeds = rng.random((3,) + shape) < density
    seeds[1] = False
    ref = np.asarray(jedt.jump_flood_sqdist(jnp.asarray(seeds)))
    out = tedt.jump_flood_sqdist(_t(seeds))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    assert int(out[1].min()) == 2**30
    assert int(out[0][_t(seeds[0])].max()) == 0
