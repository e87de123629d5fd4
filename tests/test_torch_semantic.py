"""The port's semantic front-end and multi-output entry against the JAX
package and the stored reference fixture, on the CPU.

* ``semantic_features``, ``semantic_template_weights``, the three nnU-Net
  normalisers and ``mindssc_multichannel`` against the JAX functions;
* ``convex_adam_semantic_torch`` against the unmodified reference's field in
  ``reference_semantic_48.npz``, with the CPU envelope of
  ``tests/test_reference_parity.py``, and against ``convex_adam_semantic_jax``;
* ``convex_adam_multi_output`` against the JAX package's on a 24^3 pair, and
  against the port's own single-output field.

Inputs are made from a seed with numpy and handed to both packages; every
tolerance is stated beside its assert.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from convexadam_tpu.core import features as jfeat
from convexadam_tpu.pipeline import convex_adam as jpipe
from convexadam_torch import convex_adam_multi_output, convex_adam_semantic_torch
from convexadam_torch.convert import config_from_fields
from convexadam_torch.core import features as tfeat
from convexadam_torch.core.metrics import dice_coeff
from convexadam_torch.core.warp import warp_with_displacement
from convexadam_torch.pipeline import convex_adam as tpipe

torch.set_num_threads(2)

_HERE = pathlib.Path(__file__).parent


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _labels(rng, shape=(9, 10, 11)):
    """Two label volumes with labels below 0, absent labels, and labels at
    and above ``num_labels = 7`` (4 and 5 appear in neither volume)."""
    a = rng.choice([-1, 0, 1, 2, 3, 6, 7, 9], size=shape).astype(np.int32)
    b = rng.choice([0, 1, 3, 6, 8], size=shape).astype(np.int32)
    return a, b


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_semantic_features_match_jax(rng, dtype):
    a, b = _labels(rng)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfeat.semantic_features(jnp.asarray(a), jnp.asarray(b), 7, mult=10.0, dtype=jdt)
    out = tfeat.semantic_features(_t(a), _t(b), 7, mult=10.0, dtype=tdt)
    for seg, r, o in zip((a, b), ref, out):
        r = np.asarray(r.astype(jnp.float32))
        assert o.dtype == tdt and o.shape == (7, 9, 10, 11)
        # absent labels and labels outside [0, 7) give all-zero rows
        assert not o[4:6].any() and not o.float().numpy()[:, (seg < 0) | (seg >= 7)].any()
        # XLA's and torch's float32 pow differ by an ulp on some counts: the
        # weights, hence the features, agree to 1 ulp (bf16 rounds it away)
        np.testing.assert_allclose(o.float().numpy(), r, rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_semantic_features_with_weights_match_jax_to_the_bit(rng, dtype):
    """Given the weights, the one-hot features equal JAX's bit for bit: the
    weights are cast to the feature dtype before the multiply, as JAX casts
    them."""
    a, b = _labels(rng)
    w = rng.uniform(0.1, 3.0, 7).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jfeat.semantic_features(jnp.asarray(a), jnp.asarray(b), 7, mult=3.3, dtype=jdt,
                                  weights=jnp.asarray(w))
    out = tfeat.semantic_features(_t(a), _t(b), 7, mult=3.3, dtype=tdt, weights=_t(w))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.float().numpy(), np.asarray(r.astype(jnp.float32)))


def test_semantic_template_weights_match_jax(rng):
    a, b = _labels(rng)
    ref = np.asarray(jfeat.semantic_template_weights(jnp.asarray(a), jnp.asarray(b), 9))
    out = tfeat.semantic_template_weights(_t(a), _t(b), 9).numpy()
    assert out[4] == 0 and out[5] == 0
    # pow differs by an ulp, then the mean and the division: 1e-6
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)


def test_nnunet_normalisers_match_jax(rng):
    img = (rng.standard_normal((20, 21, 22)) * 600.0 + 100.0).astype(np.float32)
    # mean and variance are sums taken in another order: 2e-5 on values of
    # a few units
    np.testing.assert_allclose(
        tfeat.nnunet_norm(_t(img)).numpy(), np.asarray(jfeat.nnunet_norm(jnp.asarray(img))),
        rtol=0, atol=2e-5,
    )
    np.testing.assert_allclose(
        tfeat.nnunet_ct_norm(_t(img)).numpy(), np.asarray(jfeat.nnunet_ct_norm(jnp.asarray(img))),
        rtol=0, atol=2e-5,
    )
    props = {"percentile_00_5": -800.0, "percentile_99_5": 1200.0, "mean": 40.0, "sd": 350.0}
    np.testing.assert_allclose(
        tfeat.nnunet_norm_props(_t(img), props).numpy(),
        np.asarray(jfeat.nnunet_norm_props(jnp.asarray(img), props)), rtol=1e-6, atol=1e-6,
    )


def test_ct_percentiles_match_jnp_quantile(rng):
    """The sort-based percentiles take any number of elements (``torch.quantile``
    refuses more than 2**24) and interpolate as ``jnp.quantile``; JAX fuses
    one multiply-add, so they agree to 1 ulp."""
    img = (rng.standard_normal((64, 64, 65)) * 600.0).astype(np.float32)
    flat = torch.sort(_t(img).reshape(-1)).values
    for q in (0.005, 0.995):
        np.testing.assert_allclose(
            float(tfeat._quantile_linear(flat, q)), float(jnp.quantile(jnp.asarray(img), q)),
            rtol=1.2e-7,
        )
    big = torch.linspace(-2000.0, 2000.0, 2**24 + 5)
    out = tfeat.nnunet_ct_norm(big)
    assert out.shape == big.shape and bool(torch.isfinite(out).all())


def test_mindssc_multichannel_matches_jax(rng):
    imgs = [rng.standard_normal((12, 13, 14)).astype(np.float32) for _ in range(2)]
    ref = np.asarray(jfeat.mindssc_multichannel([jnp.asarray(x) for x in imgs], 1, 2))
    out = tfeat.mindssc_multichannel([_t(x) for x in imgs], 1, 2).numpy()
    assert out.shape == (24, 12, 13, 14)
    # the tolerance of the mindssc test in test_torch_core.py
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def _dice(seg_f, seg_m, field, num_labels):
    warped = warp_with_displacement(
        _t(seg_m).float()[None], _t(field).permute(3, 0, 1, 2), mode="nearest"
    )[0].round().to(torch.int32)
    return float(dice_coeff(_t(seg_f), warped, num_labels).mean())


def test_semantic_entry_matches_reference_fixture():
    """The reference_semantic_48.npz case and config of
    tests/test_reference_parity.py, with its CPU envelope (mean endpoint
    error < 0.1, p95 < 0.5 voxels) and equal Dice.  The port pools and
    box-filters the cost volume with ``F.avg_pool3d``'s own rounding, which
    decides the one-hot features' argmin ties as the reference does
    (measured mean 0.0016 voxels)."""
    ref = np.load(_HERE / "reference_semantic_48.npz")
    cfg = tpipe.ConvexAdamConfig(
        lambda_weight=0.65, grid_sp=3, disp_hw=2, selected_niter=12,
        selected_smooth=0, grid_sp_adam=2, ic=True, dtype="float32",
    )
    out = convex_adam_semantic_torch(ref["seg_f"], ref["seg_m"], cfg, num_labels=3, device="cpu")
    out = out.numpy()
    assert out.shape == (48, 48, 48, 3) and out.dtype == np.float32
    rd = ref["disp"].astype(np.float32)
    epe = np.sqrt(((out - rd) ** 2).sum(-1))
    assert np.mean(epe) < 0.1, np.mean(epe)
    assert np.percentile(epe, 95) < 0.5, np.percentile(epe, 95)
    assert abs(_dice(ref["seg_f"], ref["seg_m"], out, 3)
               - _dice(ref["seg_f"], ref["seg_m"], rd, 3)) < 0.01


def test_semantic_entry_matches_jax():
    """Against ``convex_adam_semantic_jax`` on the same fixture: the JAX
    package's own CPU envelope against the reference (the two packages
    break the one-hot ties differently; equal Dice)."""
    ref = np.load(_HERE / "reference_semantic_48.npz")
    jcfg = jpipe.ConvexAdamConfig(
        lambda_weight=0.65, grid_sp=3, disp_hw=2, selected_niter=12,
        selected_smooth=0, grid_sp_adam=2, ic=True, dtype="float32",
    )
    jout = np.asarray(jpipe.convex_adam_semantic_jax(
        jnp.asarray(ref["seg_f"]), jnp.asarray(ref["seg_m"]), jcfg, num_labels=3))
    out = convex_adam_semantic_torch(
        _t(ref["seg_f"]), _t(ref["seg_m"]), config_from_fields(dataclasses.asdict(jcfg)),
        num_labels=3, device="cpu",
    ).numpy()
    epe = np.sqrt(((out - jout) ** 2).sum(-1))
    assert np.mean(epe) < 0.1, np.mean(epe)
    assert np.percentile(epe, 95) < 0.5, np.percentile(epe, 95)
    assert abs(_dice(ref["seg_f"], ref["seg_m"], out, 3)
               - _dice(ref["seg_f"], ref["seg_m"], jout, 3)) < 0.01


def _volume(shape, seed):
    """Smooth random blobs, as tests/test_pipeline.py makes them."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))[None, None]
    for _ in range(2):
        t = F.avg_pool3d(t, 3, stride=1, padding=1)
    vol = t[0, 0].numpy()
    return (vol - vol.mean()) / vol.std() * 100.0


def test_multi_output_matches_jax():
    """MIND features of a 24^3 pair rolled by (4, -5, 3): its convex init has
    no exactly-zero entry, where the fused data term takes the other
    one-sided derivative (ROADMAP §C).  Measured max |diff| 3.5e-5 voxels;
    bound 1e-3, mean 1e-4."""
    vol = _volume((24, 24, 24), 1)
    mov = np.roll(vol, (4, -5, 3), axis=(0, 1, 2))
    ff = np.asarray(jfeat.mindssc(jnp.asarray(vol), 1, 2))
    fm = np.asarray(jfeat.mindssc(jnp.asarray(mov), 1, 2))
    jcfg = jpipe.ConvexAdamConfig(grid_sp=4, disp_hw=2, dtype="float32")
    ref = np.asarray(jpipe.convex_adam_multi_output(
        jnp.asarray(ff), jnp.asarray(fm), jcfg, iters=(2, 3, 4), smoothings=(0, 3)))
    cfg = config_from_fields(dataclasses.asdict(jcfg))
    out = convex_adam_multi_output(_t(ff), _t(fm), cfg, iters=(2, 3, 4), smoothings=(0, 3),
                                   device="cpu")
    out = out.numpy()
    assert out.shape == (3, 2, 24, 24, 24, 3)
    err = np.abs(out - ref)
    assert err.max() < 1e-3, err.max()
    assert err.mean() < 1e-4, err.mean()


def test_multi_output_equals_single_output(rng):
    """Each (iterations, 0) variant is the single-output field of that
    iteration count, to the bit; an even smoothing is rounded up."""
    ff = _t(rng.standard_normal((3, 16, 16, 16)).astype(np.float32))
    fm = _t(np.roll(ff.numpy(), 1, axis=1))
    cfg = tpipe.ConvexAdamConfig(grid_sp=4, disp_hw=1, dtype="float32")
    out = convex_adam_multi_output(ff, fm, cfg, iters=(2, 3), smoothings=(0, 2, 3), device="cpu")
    assert out.shape == (2, 3, 16, 16, 16, 3)
    for i, n in enumerate((2, 3)):
        single = tpipe.convex_adam_features(ff, fm, dataclasses.replace(cfg, selected_niter=n))
        assert torch.equal(out[i, 0], single)
    assert torch.equal(out[:, 1], out[:, 2])
    with pytest.raises(ValueError, match="grid_sp_adam"):
        convex_adam_multi_output(ff, fm, dataclasses.replace(cfg, grid_sp_adam=9), iters=(1,),
                                 device="cpu")


def test_entries_default_to_cuda(monkeypatch):
    """As every entry of the port: CPU inputs without ``device="cpu"``
    still ask for the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = np.zeros((12, 12, 12), np.int32)
    feat = torch.zeros((2, 12, 12, 12))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convex_adam_semantic_torch(seg, seg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convex_adam_multi_output(feat, feat)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convex_adam_multi_output(feat, feat, device="cuda")
