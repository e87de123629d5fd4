"""The port's segmentation front end (``convexadam_torch/models``) against the
JAX package's flax U-Net, its loss, its trainer, its checkpoints and its
sliding-window inference, on the CPU, and the end-to-end semantic
registration from raw images.

The same numpy inputs, made from a seed, go to both packages; flax weights
cross over through ``convert.unet_state_dict_from_flax``.  Every tolerance
is stated beside its assert with the value measured on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from convexadam_torch.convert import unet_state_dict_from_flax
from convexadam_torch.models import segmentation as tseg
from convexadam_tpu.models import segmentation as jseg

torch.set_num_threads(2)


def _flax_params(shape, channels, num_classes=3, seed=1):
    model = jseg.UNet3D(num_classes=num_classes, channels=channels)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.zeros((1,) + shape + (1,)))
    return model, jax.tree.map(np.asarray, params)


def _port(params, channels, num_classes=3):
    model = tseg.UNet3D(num_classes, channels)
    model.load_state_dict(unet_state_dict_from_flax(params))
    return model.eval()


def _dice(pred, gt):
    inter = np.sum((pred == 1) & (gt == 1))
    return 2 * inter / ((pred == 1).sum() + (gt == 1).sum() + 1e-8)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,channels", [
    ((16, 16, 16), (4, 8)),
    ((64, 64, 28), (8, 16, 32)),  # the checkpoints' patch: 28 → 14 → 7
    ((16, 16, 14), (4, 8)),  # an odd bottleneck axis
])
def test_unet_logits_match_flax(rng, shape, channels):
    """Random flax params carried across: the logits (B, C, H, W, D) equal
    flax's (B, H, W, D, C) within 1e-4 (measured at most 1.9e-5 on logits of
    magnitude up to 5.2: flax's GroupNorm takes E[x^2] - E[x]^2, torch the
    centred variance).  The strided convolutions pad (0, 1) on even axes and
    the transposed ones run flipped, or the error would be near 3."""
    jm, params = _flax_params(shape, channels)
    x = rng.standard_normal((2,) + shape).astype(np.float32)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)[..., None]))
    with torch.no_grad():
        out = _port(params, channels)(torch.from_numpy(x)[:, None]).numpy()
    assert out.shape == (2, 3) + shape
    np.testing.assert_allclose(np.moveaxis(out, 1, -1), ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape", [(8, 9, 7), (6, 6, 5), (1, 2, 3)])
def test_down_conv_pads_as_flax(rng, shape):
    """One stride-2 ``padding="SAME"`` convolution on odd and even axes:
    (1, 1) padding on an odd axis, (0, 1) on an even one, as flax (measured
    2.4e-7; bound 1e-5)."""
    import flax.linen as nn

    conv = nn.Conv(3, (3, 3, 3), strides=(2, 2, 2), padding="SAME")
    x = rng.standard_normal((1,) + shape + (3,)).astype(np.float32)
    p = jax.tree.map(np.asarray, conv.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ref = np.asarray(conv.apply(p, jnp.asarray(x)))
    down = tseg.DownConv(3)
    with torch.no_grad():
        down.weight.copy_(torch.tensor(np.transpose(p["params"]["kernel"], (4, 3, 0, 1, 2))))
        down.bias.copy_(torch.tensor(p["params"]["bias"]))
        out = down(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    np.testing.assert_allclose(np.moveaxis(out, 1, -1), ref, rtol=0, atol=1e-5)
    assert [tseg.same_pad_stride2(n) for n in (8, 7, 1)] == [(0, 1), (1, 1), (1, 1)]


def test_unet_forward_shapes():
    """``tests/test_segmentation.py:13``: (1, 1, 16^3) → (1, 3, 16^3)."""
    model = tseg.init_unet3d_(tseg.UNet3D(3, (4, 8)), torch.Generator().manual_seed(0))
    assert model(torch.zeros(1, 1, 16, 16, 16)).shape == (1, 3, 16, 16, 16)


def test_dice_ce_loss_and_gradient_match_jax(rng):
    """The loss and its gradient in the logits on the same (2, 3, 6, 5, 4)
    logits: 1e-6 relative (measured 1.2e-7 and 6.0e-8)."""
    logits = rng.standard_normal((2, 6, 5, 4, 3)).astype(np.float32) * 3
    labels = rng.integers(0, 3, (2, 6, 5, 4))
    ref, ref_g = jax.value_and_grad(jseg.dice_ce_loss)(jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(np.moveaxis(logits, -1, 1).copy()).requires_grad_(True)
    loss = tseg.dice_ce_loss(t, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-6)
    np.testing.assert_allclose(np.moveaxis(t.grad.numpy(), 1, -1), np.asarray(ref_g),
                               rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["unet3d_anatomies", "unet3d_prostate_adc",
                                  "unet3d_prostate_multi"])
def test_stored_params_equal_the_live_conversion(name):
    """Each shipped ``params.npz`` is the conversion of the JAX package's
    orbax checkpoint, array for array, and its ``meta.json`` a copy."""
    import json

    src = tseg.CHECKPOINTS.parent.parent.parent / "convexadam_tpu" / "models" / "checkpoints"
    live = unet_state_dict_from_flax(jseg.load_unet3d(src / name / "params"))
    stored = tseg.load_unet3d(tseg.CHECKPOINTS / name / "params.npz")
    assert sorted(stored) == sorted(live)
    for k in live:
        assert torch.equal(stored[k], live[k]), k
    assert (json.loads((tseg.CHECKPOINTS / name / "meta.json").read_text())
            == json.loads((src / name / "meta.json").read_text()))
    meta = json.loads((tseg.CHECKPOINTS / name / "meta.json").read_text())
    model = tseg.UNet3D(meta["num_classes"], meta["channels"])
    assert sorted(model.state_dict()) == sorted(stored)


def test_pretrained_anatomy_checkpoint_generalizes():
    """``tests/test_segmentation.py:229`` on the port: the held-out bent
    tube's Dice > 0.7 (measured 0.9304, the JAX package's 0.9305), not
    perfect; the labels equal the JAX package's except where the CPU's
    two-class margin is below 2e-4 (measured: no voxel differs)."""
    from tests.regen_unet_anatomies import HOLDOUT_ANATOMY, holdout_case

    predictor, meta = tseg.load_pretrained_unet3d("unet3d_anatomies", device="cpu")
    assert meta["holdout_anatomy"] == HOLDOUT_ANATOMY
    img, gt = holdout_case()
    logits = tseg.blended_logits(predictor, img, meta["patch_size"], device="cpu").numpy()
    pred = tseg.sliding_window_predict(predictor, img, meta["patch_size"], device="cpu")
    np.testing.assert_array_equal(pred, np.argmax(logits, axis=0))
    assert _dice(pred, gt) > 0.7 and (pred != gt).any()
    jpred, _ = jseg.load_pretrained_unet3d("unet3d_anatomies")
    ref = jseg.sliding_window_predict(jpred, img, meta["patch_size"])
    differ = pred != ref
    assert (np.abs(logits[1] - logits[0])[differ] < 2e-4).all()


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _cube_cases(rng, n_cases=4, n=32):
    imgs, segs = [], []
    for _ in range(n_cases):
        seg = np.zeros((n, n, n), np.int32)
        o = rng.integers(-4, 5, 3)
        seg[8 + o[0]: 22 + o[0], 8 + o[1]: 22 + o[1], 8 + o[2]: 22 + o[2]] = 1
        img = seg * 2.0 + rng.standard_normal(seg.shape).astype(np.float32) * 0.2
        imgs.append(img.astype(np.float32))
        segs.append(seg)
    return np.stack(imgs), np.stack(segs)


def test_train_unet3d_first_losses_match_jax():
    """From the same params (flax's, carried across), five steps on the
    same patches (``fg_fraction`` 0.5, so the foreground draws too): each
    loss within 1e-4 relative of the JAX trainer's (measured 3.1e-6)."""
    imgs, segs = _cube_cases(np.random.default_rng(1))
    kw = dict(num_classes=2, patch_size=(16, 16, 16), steps=5, batch_size=2,
              learning_rate=3e-3, channels=(4, 8), seed=0, fg_fraction=0.5)
    _, params = _flax_params((16, 16, 16), (4, 8), num_classes=2, seed=0)
    _, ref = jseg.train_unet3d(imgs, segs, params=params, **kw)
    _, hist = tseg.train_unet3d(imgs, segs, params=unet_state_dict_from_flax(params),
                                device="cpu", **kw)
    np.testing.assert_allclose(hist, ref, rtol=1e-4)


def test_train_unet3d_rejects_ragged_patches():
    with pytest.raises(ValueError, match="patch_size"):
        tseg.train_unet3d(np.zeros((1, 8, 8, 8)), np.zeros((1, 8, 8, 8)), 2,
                          patch_size=(16, 8, 8), steps=1, device="cpu")


@pytest.fixture(scope="module")
def trained():
    """``tests/test_segmentation.py:159``'s training: four cube cases,
    150 steps at 16^3 with channels (4, 8), from a seeded generator."""
    imgs, segs = _cube_cases(np.random.default_rng(1))
    model, history = tseg.train_unet3d(
        imgs, segs, num_classes=2, patch_size=(16, 16, 16), steps=150, batch_size=2,
        learning_rate=3e-3, channels=(4, 8), seed=0, device="cpu",
    )
    return model, history, imgs, segs


def test_train_save_load_predict_roundtrip(trained, tmp_path):
    """``tests/test_segmentation.py:159`` on the port: the loss falls below
    0.7 of its start, an ``.npz`` save/load gives the same predictor, and
    the trained network segments a training volume with Dice > 0.8."""
    model, history, imgs, segs = trained
    assert history[-1] < history[0] * 0.7, (history[0], history[-1])
    tseg.save_unet3d(model, tmp_path / "unet.npz")
    again = tseg.UNet3D(2, (4, 8))
    again.load_state_dict(tseg.load_unet3d(tmp_path / "unet.npz"))
    lab_a = tseg.sliding_window_predict(tseg.make_predictor(model), imgs[0], (16, 16, 16),
                                        device="cpu")
    lab_b = tseg.sliding_window_predict(tseg.make_predictor(again), imgs[0], (16, 16, 16),
                                        device="cpu")
    np.testing.assert_array_equal(lab_a, lab_b)
    assert _dice(lab_a, segs[0]) > 0.8


def test_trainer_restores_the_caller_tf32_setting(monkeypatch):
    """TF32 is off inside the trainer and the predictor; the caller's
    setting comes back after."""
    seen = []
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = tseg.init_unet3d_(tseg.UNet3D(2, (4, 8)), torch.Generator().manual_seed(0))
    forward = model.forward
    monkeypatch.setattr(model, "forward", lambda x: (seen.append(
        (torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())), forward(x))[1])
    tseg.make_predictor(model)(torch.zeros(1, 16, 16, 16))
    assert seen == [(False, "highest")] and torch.backends.cudnn.allow_tf32 is True


# ---------------------------------------------------------------------------
# sliding-window inference and the entry from images
# ---------------------------------------------------------------------------

def _threshold(patches):
    """A voxelwise two-class predictor (B, h, w, d) → (B, 2, h, w, d)."""
    return torch.stack([1.0 - patches, patches - 1.0], dim=1)


def _jax_threshold(patch):
    return jnp.stack([1.0 - patch, patch - 1.0], axis=-1)


def test_sliding_window_matches_direct_for_shift_invariant_fn(rng):
    """``tests/test_segmentation.py:21`` on the port: for a voxelwise
    predictor the blended labels equal direct inference and the JAX
    package's labels; a volume smaller than the patch is edge-padded so the
    predictor sees only the patch shape, then cropped back."""
    vol = rng.standard_normal((20, 24, 28)).astype(np.float32) + 1.0
    out = tseg.sliding_window_predict(_threshold, vol, (8, 8, 8), device="cpu")
    direct = torch.argmax(_threshold(torch.from_numpy(vol)[None])[0], 0).numpy()
    np.testing.assert_array_equal(out, direct)
    np.testing.assert_array_equal(out, jseg.sliding_window_predict(_jax_threshold, vol,
                                                                   (8, 8, 8)))
    seen = []

    def logging(patches):
        seen.append(tuple(patches.shape[1:]))
        return _threshold(patches)

    small = rng.standard_normal((5, 6, 7)).astype(np.float32) + 1.0
    out_s = tseg.sliding_window_predict(logging, small, (8, 8, 8), device="cpu")
    assert out_s.shape == small.shape and set(seen) == {(8, 8, 8)}
    np.testing.assert_array_equal(out_s, jseg.sliding_window_predict(_jax_threshold, small,
                                                                     (8, 8, 8)))


def test_blended_logits_match_jax_accumulation(rng):
    """The blended logits of a U-Net with flax weights over a 20 x 17 x 12
    volume (windows in batches, a non-Gaussian map too): the JAX package's
    ``acc / norm`` within 1e-5 (measured 3.8e-6: the network's own
    rounding)."""
    jm, params = _flax_params((8, 8, 8), (4, 8), num_classes=2)
    model = _port(params, (4, 8), num_classes=2)
    vol = rng.standard_normal((20, 17, 12)).astype(np.float32)

    @jax.jit
    def jpred(patch):
        return jm.apply(params, patch[None, ..., None])[0]

    for gaussian in (True, False):
        got = tseg.blended_logits(tseg.make_predictor(model), vol, (8, 8, 8), 0.5, gaussian,
                                  device="cpu").numpy()
        # the JAX package's accumulation, spelled out
        from convexadam_tpu.utils.sliding_window import (
            compute_steps_for_sliding_window,
            get_gaussian,
        )
        steps = compute_steps_for_sliding_window((8, 8, 8), vol.shape, 0.5)
        imp = get_gaussian((8, 8, 8)) if gaussian else np.ones((8, 8, 8), np.float32)
        acc = np.zeros(vol.shape + (2,), np.float32)
        norm = np.zeros(vol.shape, np.float32)
        for sx in steps[0]:
            for sy in steps[1]:
                for sz in steps[2]:
                    sl = (slice(sx, sx + 8), slice(sy, sy + 8), slice(sz, sz + 8))
                    acc[sl] += np.asarray(jpred(jnp.asarray(vol[sl]))) * imp[..., None]
                    norm[sl] += imp
        np.testing.assert_allclose(np.moveaxis(got, 0, -1), acc / norm[..., None], rtol=0,
                                   atol=1e-5)


def _entry_cases():
    """The JAX package's 32^3 cube case: the fixed cube and one moved by
    (3, -2, 2), with noise."""
    rng = np.random.default_rng(0)

    def case(offset):
        seg = np.zeros((32, 32, 32), np.int32)
        o = np.asarray(offset)
        seg[8 + o[0]: 22 + o[0], 8 + o[1]: 22 + o[1], 8 + o[2]: 22 + o[2]] = 1
        img = seg * 2.0 + rng.standard_normal(seg.shape).astype(np.float32) * 0.2
        return img.astype(np.float32), seg

    return case((0, 0, 0)), case((3, -2, 2))


def _warped_dice(seg_f, seg_m, disp):
    from convexadam_torch.core.metrics import dice_coeff
    from convexadam_torch.core.warp import warp_with_displacement

    warped = warp_with_displacement(torch.from_numpy(seg_m).float()[None],
                                    torch.tensor(disp).permute(3, 0, 1, 2),
                                    mode="nearest")[0].round().to(torch.int32)
    return float(dice_coeff(torch.from_numpy(seg_f), warped, 2).mean())


def test_semantic_from_images_matches_jax():
    """``convex_adam_semantic_from_images`` against the JAX entry on the
    cube case with one voxelwise predictor in both: the labels are equal;
    the field equals ``convex_adam_semantic_torch`` on those labels to the
    bit, and is held to the JAX entry's as ``tests/test_torch_semantic.py``
    and ``tests/test_torch_l2r.py`` hold one-hot arms, by the warped Dice
    (the two packages break one-hot argmin ties differently, ROADMAP C;
    here the fields are 0.18 voxels apart on average): within 0.01
    (measured 0.9797 against 0.9864), both above the identity's 0.5773 by
    more than 0.1."""
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig as TConfig
    from convexadam_torch.pipeline.convex_adam import (
        convex_adam_semantic_from_images,
        convex_adam_semantic_torch,
    )
    from convexadam_tpu.pipeline import convex_adam as jpipe

    (fi, fs), (mi, ms) = _entry_cases()
    kw = dict(grid_sp=3, disp_hw=2, lambda_weight=1.0, selected_niter=30, grid_sp_adam=2,
              dtype="float32")
    ref = jpipe.convex_adam_semantic_from_images(fi, mi, _jax_threshold, (16, 16, 16),
                                                 jpipe.ConvexAdamConfig(**kw), normalize=False)
    out = convex_adam_semantic_from_images(fi, mi, _threshold, (16, 16, 16), TConfig(**kw),
                                           normalize=False, device="cpu")
    assert out.shape == (32, 32, 32, 3) and out.dtype == np.float32
    labels = []
    for img in (fi, mi):
        lab = tseg.sliding_window_predict(_threshold, img, (16, 16, 16), device="cpu")
        np.testing.assert_array_equal(lab, jseg.sliding_window_predict(_jax_threshold, img,
                                                                       (16, 16, 16)))
        labels.append(lab)
    composed = convex_adam_semantic_torch(*labels, TConfig(**kw), num_labels=2, device="cpu")
    np.testing.assert_array_equal(out, composed.numpy())
    d_out, d_ref = _warped_dice(fs, ms, out), _warped_dice(fs, ms, ref)
    d0 = _warped_dice(fs, ms, np.zeros_like(out))
    assert abs(d_out - d_ref) < 0.01, (d_out, d_ref)
    assert min(d_out, d_ref) > d0 + 0.1, (d_out, d_ref, d0)


def test_end_to_end_semantic_registration_from_images(trained):
    """``tests/test_segmentation.py:50`` on the port: the trained U-Net's
    labels register two raw cube volumes; the warped moving cube's Dice
    beats the identity's by more than 0.1."""
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig
    from convexadam_torch.pipeline.convex_adam import convex_adam_semantic_from_images

    model = trained[0]
    (fi, fs), (mi, ms) = _entry_cases()
    cfg = ConvexAdamConfig(grid_sp=3, disp_hw=2, lambda_weight=1.0, selected_niter=30,
                           grid_sp_adam=2)
    disp = convex_adam_semantic_from_images(fi, mi, tseg.make_predictor(model), (16, 16, 16),
                                            cfg, normalize=False, device="cpu")
    assert disp.shape == (32, 32, 32, 3)
    d0 = _warped_dice(fs, ms, np.zeros_like(disp))
    assert _warped_dice(fs, ms, disp) > d0 + 0.1


def test_entries_default_to_cuda():
    """Without ``device="cpu"`` the predictor loader, the window inference,
    the trainer and the entry ask for the card, and raise where there is
    none."""
    from convexadam_torch import convex_adam_semantic_from_images

    vol = np.zeros((8, 8, 8), np.float32)
    for call in (lambda: tseg.load_pretrained_unet3d("unet3d_anatomies"),
                 lambda: tseg.sliding_window_predict(_threshold, vol, (8, 8, 8)),
                 lambda: tseg.train_unet3d(vol[None], vol[None].astype(int), 2,
                                           patch_size=(8, 8, 8), steps=1),
                 lambda: convex_adam_semantic_from_images(vol, vol, _threshold, (8, 8, 8))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
