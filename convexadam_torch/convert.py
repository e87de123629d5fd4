"""Carry state from the JAX package into the port.

The main path has no learned weights: MIND-SSC is handcrafted and the only
trainable tensor, the Adam grid, is made anew for every pair.  What crosses
over is the configuration and arrays in the JAX package's layouts, which the
port keeps unchanged: features (C, H, W, D), fields (3, H, W, D) with
channels in array order, final fields (H, W, D, 3) in voxels.  The one
set of learned weights is the segmentation front end's U-Net:
:func:`unet_state_dict_from_flax` carries a flax parameter tree into a
:class:`~convexadam_torch.models.segmentation.UNet3D` ``state_dict``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

_TUPLE_FIELDS = ("adam_smoother", "snapshot_iters")


def config_from_fields(fields: dict) -> ConvexAdamConfig:
    """The port's config from ``dataclasses.asdict`` of a JAX-package
    ``ConvexAdamConfig``; a field the port does not know raises."""
    known = {f.name for f in dataclasses.fields(ConvexAdamConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown ConvexAdamConfig fields: {unknown}")
    vals = dict(fields)
    for name in _TUPLE_FIELDS:
        if name in vals:
            vals[name] = tuple(vals[name])
    return ConvexAdamConfig(**vals)


def tensor_from_numpy(arr, device: "str | torch.device | None" = None) -> torch.Tensor:
    """A numpy array (float32, or bfloat16 as JAX hands it out) as a tensor
    of the same layout and dtype on ``device`` (``cuda`` by default)."""
    dev = _resolve_device(device)
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=dev).to(torch.bfloat16)
    return torch.tensor(arr, device=dev)


def _f32(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a, np.float32))


def _conv_weight(kernel) -> torch.Tensor:
    """flax ``Conv`` kernel (kh, kw, kd, Cin, Cout) → ``Conv3d`` weight
    (Cout, Cin, kh, kw, kd)."""
    return _f32(np.transpose(np.asarray(kernel), (4, 3, 0, 1, 2)))


def _conv_transpose_weight(kernel) -> torch.Tensor:
    """flax ``ConvTranspose`` kernel (kh, kw, kd, Cin, Cout), which flax
    applies unflipped (``transpose_kernel=False``) → ``ConvTranspose3d``
    weight (Cin, Cout, kh, kw, kd), flipped on the three spatial axes."""
    return _f32(np.transpose(np.asarray(kernel), (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1])


def unet_state_dict_from_flax(params) -> dict:
    """The JAX package's ``UNet3D`` parameters (the tree ``load_unet3d``
    returns, numpy arrays, with or without its ``"params"`` level) as the
    port's ``UNet3D`` ``state_dict``.

    flax numbers submodules in creation order: with n = len(channels) - 1
    levels, ``ConvBlock_0..n-1`` are the encoder, ``ConvBlock_n`` the
    bottleneck and ``ConvBlock_n+1..2n`` the decoder; ``Conv_0..n-1`` the
    stride-2 downsampling and ``Conv_n`` the 1^3 head;
    ``ConvTranspose_0..n-1`` the upsampling."""
    p = params.get("params", params)
    n = sum(1 for k in p if k.startswith("ConvTranspose_"))
    out: dict = {}

    def block(prefix, tree):
        for i in range(2):
            conv, norm = tree[f"Conv_{i}"], tree[f"GroupNorm_{i}"]
            out[f"{prefix}.conv{i}.weight"] = _conv_weight(conv["kernel"])
            out[f"{prefix}.conv{i}.bias"] = _f32(conv["bias"])
            out[f"{prefix}.norm{i}.weight"] = _f32(norm["scale"])
            out[f"{prefix}.norm{i}.bias"] = _f32(norm["bias"])

    def conv(prefix, tree, weight=_conv_weight):
        out[f"{prefix}.weight"] = weight(tree["kernel"])
        out[f"{prefix}.bias"] = _f32(tree["bias"])

    for i in range(n):
        block(f"encoder.{i}", p[f"ConvBlock_{i}"])
        conv(f"downs.{i}", p[f"Conv_{i}"])
        conv(f"ups.{i}", p[f"ConvTranspose_{i}"], _conv_transpose_weight)
        block(f"decoder.{i}", p[f"ConvBlock_{n + 1 + i}"])
    block("bottleneck", p[f"ConvBlock_{n}"])
    conv("head", p[f"Conv_{n}"])
    return out
