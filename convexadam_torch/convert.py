"""Carry state from the JAX package into the port.

The main path has no learned weights: MIND-SSC is handcrafted and the only
trainable tensor, the Adam grid, is made anew for every pair.  What crosses
over is the configuration and arrays in the JAX package's layouts, which the
port keeps unchanged: features (C, H, W, D), fields (3, H, W, D) with
channels in array order, final fields (H, W, D, 3) in voxels.
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
