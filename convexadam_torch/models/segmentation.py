"""Segmentation front end: a compact nnU-Net-style 3D U-Net and
Gaussian-blended sliding-window inference.

Counterpart of ``convexadam_tpu/models/segmentation.py``.  The reference
reads nnU-Net predictions from disk (``predictedlabels``,
main_for_l2r3_nnUNet.py:76-80); this module makes them, so that semantic
registration runs from raw images
(:func:`~convexadam_torch.pipeline.convex_adam.convex_adam_semantic_from_images`).

The network follows the nnU-Net recipe: 3^3 convolutions, instance norm,
leaky ReLU, strided-convolution downsampling, transposed-convolution
upsampling and skip concatenation.  It takes (B, 1, H, W, D) and gives (B,
num_classes, H, W, D) logits, the spatial axes in the JAX package's order.
Three flax conventions are kept so that the JAX package's weights give the
same logits (:func:`convexadam_torch.convert.unet_state_dict_from_flax`):

* a stride-2 ``padding="SAME"`` convolution pads each axis by ``(total //
  2, total - total // 2)`` with ``total = max((ceil(n/2) - 1)*2 + 3 - n,
  0)``: (0, 1) on an even axis, (1, 1) on an odd one;
* flax's transposed convolution is ``F.conv_transpose3d`` with the kernel
  flipped on its three spatial axes;
* GroupNorm's epsilon is 1e-6.

The convolutions are cuDNN's (``F.conv3d``, ``F.conv_transpose3d``): the
JAX package runs them as XLA convolutions, not as Pallas kernels.  The
predictor and the trainer run with TF32 off and restore the caller's
setting after (:func:`convexadam_torch.core.rigid._f32_matmuls`), so the
card's convolutions keep float32 mantissas.
"""

from __future__ import annotations

import json
import math
import pathlib
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from convexadam_torch import _resolve_device
from convexadam_torch.core.rigid import _f32_matmuls
from convexadam_torch.utils.sliding_window import compute_steps_for_sliding_window, get_gaussian

GROUPNORM_EPS = 1e-6  # flax.linen.GroupNorm's
LEAKY_SLOPE = 0.01
# optax.adamw's defaults: weight decay on every parameter, eps and betas
ADAMW_WEIGHT_DECAY = 1e-4
ADAMW_EPS = 1e-8
ADAMW_BETAS = (0.9, 0.999)
# windows a predictor call takes in sliding-window inference
WINDOW_BATCH = 8

CHECKPOINTS = pathlib.Path(__file__).parent / "checkpoints"


def same_pad_stride2(n: int, kernel: int = 3) -> "tuple[int, int]":
    """flax's ``padding="SAME"`` of a stride-2 convolution on an axis of
    ``n`` voxels: (low, high)."""
    total = max((-(-n // 2) - 1) * 2 + kernel - n, 0)
    return total // 2, total - total // 2


class DownConv(nn.Conv3d):
    """A 3^3 stride-2 convolution with flax's asymmetric SAME padding."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for n in reversed(x.shape[2:]):  # F.pad takes the last axis first
            pads += same_pad_stride2(int(n))
        return super().forward(F.pad(x, pads))


class ConvBlock(nn.Module):
    """Two (3^3 convolution, instance norm, leaky ReLU) layers."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv0 = nn.Conv3d(in_channels, features, 3, padding=1)
        self.norm0 = nn.GroupNorm(features, features, eps=GROUPNORM_EPS)
        self.conv1 = nn.Conv3d(features, features, 3, padding=1)
        self.norm1 = nn.GroupNorm(features, features, eps=GROUPNORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.norm0(self.conv0(x)), LEAKY_SLOPE)
        return F.leaky_relu(self.norm1(self.conv1(x)), LEAKY_SLOPE)


class UNet3D(nn.Module):
    """nnU-Net-style encoder/decoder: (B, 1, H, W, D) → (B, num_classes, H,
    W, D) logits.  Each axis must halve evenly down to the bottleneck (H,
    W, D divisible by 2^(len(channels) - 2)), as in the JAX package, or the
    skip concatenation does not fit."""

    def __init__(self, num_classes: int, channels: Sequence[int] = (16, 32, 64)):
        super().__init__()
        self.num_classes = int(num_classes)
        self.channels = tuple(int(c) for c in channels)
        cin = 1
        self.encoder = nn.ModuleList()
        self.downs = nn.ModuleList()
        for c in self.channels[:-1]:
            self.encoder.append(ConvBlock(cin, c))
            self.downs.append(DownConv(c))
            cin = c
        self.bottleneck = ConvBlock(cin, self.channels[-1])
        cin = self.channels[-1]
        self.ups = nn.ModuleList()
        self.decoder = nn.ModuleList()
        for c in reversed(self.channels[:-1]):
            self.ups.append(nn.ConvTranspose3d(cin, c, 2, stride=2))
            self.decoder.append(ConvBlock(2 * c, c))
            cin = c
        self.head = nn.Conv3d(self.channels[0], self.num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for block, down in zip(self.encoder, self.downs):
            x = block(x)
            skips.append(x)
            x = down(x)
        x = self.bottleneck(x)
        for up, block, skip in zip(self.ups, self.decoder, reversed(skips)):
            x = block(torch.cat([up(x), skip], dim=1))
        return self.head(x)


def init_unet3d_(model: UNet3D, generator: torch.Generator) -> UNet3D:
    """flax's initialisation, drawn from ``generator``: LeCun-normal kernels
    (a normal truncated at two deviations, scaled to variance 1 / fan_in,
    fan_in = input channels x kernel volume), zero biases, unit norm
    scales."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                w = m.weight
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose3d) else w.shape[1]
                std = math.sqrt(1.0 / (cin * math.prod(w.shape[2:]))) / 0.87962566103423978
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
    return model


def dice_ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """nnU-Net's training objective: class-mean soft Dice over batch and
    space plus voxel-mean cross-entropy.  ``logits`` (B, C, ...), ``labels``
    (B, ...) integers."""
    num_classes = logits.shape[1]
    onehot = F.one_hot(labels.long(), num_classes).movedim(-1, 1).to(logits.dtype)
    probs = torch.softmax(logits, dim=1)
    axes = (0,) + tuple(range(2, logits.ndim))
    inter = torch.sum(probs * onehot, dim=axes)
    denom = torch.sum(probs, dim=axes) + torch.sum(onehot, dim=axes)
    dice = torch.mean(1.0 - (2.0 * inter + 1e-5) / (denom + 1e-5))
    ce = -torch.mean(torch.sum(onehot * torch.log_softmax(logits, dim=1), dim=1))
    return dice + ce


@_f32_matmuls
def train_unet3d(
    images: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    patch_size=(32, 32, 32),
    steps: int = 200,
    batch_size: int = 2,
    learning_rate: float = 1e-3,
    channels=(16, 32, 64),
    seed: int = 0,
    params: "dict | None" = None,
    fg_fraction: float = 0.0,
    verbose: bool = False,
    device: "str | torch.device | None" = None,
) -> "tuple[UNet3D, list[float]]":
    """Train a :class:`UNet3D` on random patches: Dice + CE, AdamW on a
    cosine decay (optax ``adamw`` with its defaults: weight decay 1e-4 on
    every parameter, eps 1e-8, betas (0.9, 0.999)).  The learning rate of
    update t (from 0) is ``learning_rate * (1 + cos(pi * min(t, T) / T)) /
    2`` with ``T = max(steps, 1)``, in closed form.

    ``images``/``labels``: (N, H, W, D) float / int volumes.  The patches
    are drawn from ``np.random.default_rng(seed)`` in the JAX package's
    order; ``fg_fraction`` of them are centred on a random foreground voxel
    (nnU-Net's oversampling of sparse targets).  The initial weights come
    from a ``torch.Generator`` seeded with ``seed`` (:func:`init_unet3d_`),
    or from ``params``, a ``state_dict`` to fine-tune.  Runs on ``cuda``
    unless ``device="cpu"``.  Returns (the trained model, the loss of every
    step)."""
    dev = _resolve_device(device)
    images = np.asarray(images, np.float32)
    labels = np.asarray(labels, np.int32)
    if any(p > s for p, s in zip(patch_size, images.shape[1:])):
        # a short axis would give ragged patches
        raise ValueError(
            f"patch_size {tuple(patch_size)} exceeds volume shape "
            f"{images.shape[1:]} — pad the volumes or shrink the patch"
        )
    model = UNet3D(num_classes, channels)
    if params is None:
        init_unet3d_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    model.to(dev).train()
    rng = np.random.default_rng(seed)
    opt = torch.optim.AdamW(model.parameters(), lr=learning_rate, betas=ADAMW_BETAS,
                            eps=ADAMW_EPS, weight_decay=ADAMW_WEIGHT_DECAY)
    total = max(steps, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: 0.5 * (1.0 + math.cos(math.pi * min(t, total) / total))
    )
    fg_voxels = [np.argwhere(lab > 0) for lab in labels] if fg_fraction > 0 else None

    def sample_batch():
        xs, ys = [], []
        for _ in range(batch_size):
            i = rng.integers(0, len(images))
            if fg_voxels is not None and len(fg_voxels[i]) and rng.random() < fg_fraction:
                # centre the patch on a random foreground voxel, clamped
                # into the volume
                c = fg_voxels[i][rng.integers(0, len(fg_voxels[i]))]
                starts = [int(np.clip(cv - p // 2, 0, max(s - p, 0)))
                          for cv, s, p in zip(c, images[i].shape, patch_size)]
            else:
                starts = [rng.integers(0, max(s - p, 0) + 1)
                          for s, p in zip(images[i].shape, patch_size)]
            sl = tuple(slice(s, s + p) for s, p in zip(starts, patch_size))
            xs.append(images[i][sl])
            ys.append(labels[i][sl])
        return (torch.from_numpy(np.stack(xs)).to(dev),
                torch.from_numpy(np.stack(ys)).to(dev))

    history = []
    for it in range(steps):
        x, y = sample_batch()
        loss = dice_ce_loss(model(x[:, None]), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        history.append(loss.item())
        if verbose and it % 50 == 0:
            print(f"step {it}: loss {history[-1]:.4f}")
    return model.eval(), history


def save_unet3d(model: "UNet3D | dict", path) -> None:
    """Write a model's ``state_dict`` (or a ``state_dict``) as an ``.npz``
    of float32 arrays."""
    state = model.state_dict() if isinstance(model, nn.Module) else model
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in state.items()})


def load_unet3d(path) -> dict:
    """The ``state_dict`` an ``.npz`` of :func:`save_unet3d` holds, as CPU
    tensors."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k].copy()) for k in z.files}


def make_predictor(module: UNet3D) -> Callable[[torch.Tensor], torch.Tensor]:
    """Bind a network into the patch → logits function that
    :func:`sliding_window_predict` and
    ``convex_adam_semantic_from_images`` consume: a batch of patches (B, h,
    w, d) → logits (B, C, h, w, d) float32 on the module's device, under
    ``no_grad`` and with TF32 off (the caller's setting restored after)."""
    module.eval()

    @torch.no_grad()
    @_f32_matmuls
    def predict_logits(patches: torch.Tensor) -> torch.Tensor:
        return module(patches.float()[:, None])

    return predict_logits


def load_pretrained_unet3d(
    name: str = "unet3d_prostate_adc", device: "str | torch.device | None" = None
):
    """A checkpoint shipped with the package (``models/checkpoints/<name>/``:
    ``params.npz`` and ``meta.json``, converted from the JAX package's orbax
    checkpoints by ``scripts/convert_unet_checkpoints.py``) bound into a
    predictor on ``device`` (``cuda`` unless ``device="cpu"``).

    Returns ``(predict_logits, meta)``; ``meta`` carries ``num_classes``,
    ``channels``, ``patch_size`` and the input ``normalization`` ("zscore":
    feed ``(v - v.mean()) / v.std()``).  Shipped: ``unet3d_prostate_adc``,
    ``unet3d_prostate_multi`` and ``unet3d_anatomies`` (regeneration recipes
    under ``tests/regen_unet_*.py``)."""
    dev = _resolve_device(device)
    root = CHECKPOINTS / name
    meta = json.loads((root / "meta.json").read_text())
    model = UNet3D(meta["num_classes"], meta["channels"])
    model.load_state_dict(load_unet3d(root / "params.npz"))
    return make_predictor(model.to(dev)), meta


def blended_logits(
    predict_logits: Callable[[torch.Tensor], torch.Tensor],
    volume,
    patch_size: Sequence[int],
    step_size: float = 0.5,
    gaussian: bool = True,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """The Gaussian-blended logits ``acc / norm`` (C, H, W, D) float32 of
    sliding-window inference over ``volume`` (H, W, D; numpy or a tensor),
    on ``device`` (``cuda`` unless ``device="cpu"``).

    Short axes are edge-padded up to the patch first (the network was
    trained at ``patch_size``, whose stride-2 levels need those extents)
    and cropped back after.  Windows start at
    :func:`compute_steps_for_sliding_window`'s coordinates and go to
    ``predict_logits`` :data:`WINDOW_BATCH` at a time; each window's logits
    times the importance map are added to the accumulator in window order,
    and the map itself to the normaliser, as in the JAX package."""
    dev = _resolve_device(device)
    vol_t = torch.as_tensor(volume).to(dev, torch.float32)
    patch_size = [int(p) for p in patch_size]
    pad = [max(0, p - s) for p, s in zip(patch_size, vol_t.shape)]
    if any(pad):  # np.pad's "edge": replicate the last plane
        vol_t = F.pad(vol_t[None, None], (0, pad[2], 0, pad[1], 0, pad[0]), mode="replicate")[0, 0]
    shape = tuple(vol_t.shape)
    steps = compute_steps_for_sliding_window(patch_size, shape, step_size)
    imp_np = get_gaussian(patch_size) if gaussian else np.ones(patch_size, np.float32)
    imp = torch.from_numpy(imp_np).to(dev)
    windows = [
        tuple(slice(s, s + p) for s, p in zip((sx, sy, sz), patch_size))
        for sx in steps[0] for sy in steps[1] for sz in steps[2]
    ]
    acc = None
    norm = torch.zeros(shape, dtype=torch.float32, device=dev)
    for a in range(0, len(windows), WINDOW_BATCH):
        batch = windows[a:a + WINDOW_BATCH]
        logits = predict_logits(torch.stack([vol_t[w] for w in batch])).float()
        if acc is None:
            acc = torch.zeros((logits.shape[1],) + shape, dtype=torch.float32, device=dev)
        for w, lg in zip(batch, logits):
            acc[(slice(None),) + w] += lg * imp
            norm[w] += imp
    out = acc / norm
    return out[:, : shape[0] - pad[0], : shape[1] - pad[1], : shape[2] - pad[2]]


def sliding_window_predict(
    predict_logits: Callable[[torch.Tensor], torch.Tensor],
    volume,
    patch_size: Sequence[int],
    step_size: float = 0.5,
    gaussian: bool = True,
    device: "str | torch.device | None" = None,
) -> np.ndarray:
    """Label volume (H, W, D) int32 of ``volume`` (H, W, D): the first
    maximum over classes of :func:`blended_logits` (the nnU-Net inference
    scheme, convex_adam_utils.py:196-237).  ``predict_logits`` maps patches
    (B, h, w, d) to logits (B, C, h, w, d) (:func:`make_predictor`).  Runs
    on ``cuda`` unless ``device="cpu"``."""
    return predict_labels(predict_logits, volume, patch_size, step_size, gaussian,
                          device).cpu().numpy()


def predict_labels(predict_logits, volume, patch_size, step_size=0.5, gaussian=True,
                   device=None) -> torch.Tensor:
    """:func:`sliding_window_predict`'s labels as an int32 tensor on the
    device."""
    logits = blended_logits(predict_logits, volume, patch_size, step_size, gaussian, device)
    return torch.argmax(logits, dim=0).to(torch.int32)
