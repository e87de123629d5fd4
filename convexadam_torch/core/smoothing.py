"""Box / Gaussian / spline smoothing with exact ``F.avg_pool3d`` semantics.

Counterpart of ``convexadam_tpu/core/smoothing.py``.  Two border semantics:

* ``avg_pool3d(x, k, stride, padding)`` -- zero padding, and with
  ``count_include_pad=True`` the divisor is always ``k**3``;
* ``avg_pool3d_replicate(x, k)`` -- replicate padding by ``k // 2``.

Overlapping box filters are separable window sums over the last three axes,
taken in H, W, D order with the window offsets ``j`` added in ascending
order, as the JAX package sums them; they are differentiable with a
deterministic backward, so the Adam smoothers use them.  Non-overlapping
pooling (:func:`window_mean3d`) is ``F.avg_pool3d`` itself; so are the cost
volume's box passes, the plain version of ``kernels/box.py``'s kernel: the
reference's rounding, which decides the argmin ties of one-hot semantic
features.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _window_sum_axis(x: torch.Tensor, axis: int, k: int, stride: int, pad: int) -> torch.Tensor:
    """1-D window sum along ``axis``: ``k`` shifted (strided) slices, zero
    padded by ``pad`` on both sides, added with ``j`` ascending."""
    axis = axis % x.ndim
    if pad:
        spec = [0, 0] * (x.ndim - 1 - axis) + [pad, pad]
        x = F.pad(x, spec)
    n = x.shape[axis]
    out_n = (n - k) // stride + 1
    acc = None
    for j in range(k):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(j, j + (out_n - 1) * stride + 1, stride)
        term = x[tuple(sl)]
        acc = term if acc is None else acc + term
    return acc


def window_mean3d(x: torch.Tensor, kernel: int, stride: int, padding: int = 0) -> torch.Tensor:
    """``F.avg_pool3d`` (zero padding, ``count_include_pad=True``) over the
    last three axes of ``x`` (any leading dims), computed in float32 and
    returned in ``x``'s dtype.  Each output adds its window's ``k**3`` terms
    in window order and divides by ``k**3``: the reference's rounding, bit
    for bit.  Its CUDA backward adds with atomics, so gradient loops use
    :func:`avg_pool3d`'s separable sums instead."""
    y = F.avg_pool3d(
        x.float().reshape(1, -1, *x.shape[-3:]), kernel, stride=stride, padding=padding
    )
    return y.reshape(*x.shape[:-3], *y.shape[-3:]).to(x.dtype)


def avg_pool3d(
    x: torch.Tensor,
    kernel: int,
    stride: "int | None" = None,
    padding: int = 0,
    count_include_pad: bool = True,
) -> torch.Tensor:
    """``F.avg_pool3d`` over the last three axes of ``x`` (any leading dims).

    The non-overlapping case (``stride == kernel``, no padding) is
    :func:`window_mean3d`, accumulated in float32 and returned in ``x``'s
    dtype; the overlapping case is the separable window sum of the module
    docstring.
    """
    if stride is None:
        stride = kernel
    nd = x.ndim
    if stride == kernel and padding == 0:
        return window_mean3d(x, kernel, kernel)
    out = x
    for ax in (nd - 3, nd - 2, nd - 1):
        out = _window_sum_axis(out, ax, kernel, stride, padding)
    if count_include_pad:
        return out / float(kernel**3)
    cnt = torch.ones(x.shape[-3:], dtype=x.dtype, device=x.device)
    for ax in (0, 1, 2):
        cnt = _window_sum_axis(cnt, ax, kernel, stride, padding)
    return out / cnt


def replicate_pad3d(x: torch.Tensor, r: int) -> torch.Tensor:
    """Edge-pad the last three axes of ``x`` by ``r`` (any leading dims)."""
    if r == 0:
        return x
    for ax in (x.ndim - 3, x.ndim - 2, x.ndim - 1):
        n = x.shape[ax]
        idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
        x = x.index_select(ax, idx)
    return x


def avg_pool3d_replicate(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """Stride-1 box filter with replicate padding, output the same size."""
    return avg_pool3d(replicate_pad3d(x, kernel // 2), kernel, stride=1, padding=0)


def box_smooth_repeated(x: torch.Tensor, kernel: int, repeats: int) -> torch.Tensor:
    """``repeats`` cascaded stride-1 zero-padded box filters.  Each pass
    re-pads with zeros, so the cascade does not collapse into one filter."""
    pad = kernel // 2
    for _ in range(repeats):
        x = avg_pool3d(x, kernel, stride=1, padding=pad)
    return x


def filter1d(x: torch.Tensor, weight: "list[float]", axis: int) -> torch.Tensor:
    """Correlate ``x`` with the 1-D kernel ``weight`` along ``axis`` with
    replicate padding by ``len(weight) // 2``."""
    n = len(weight)
    r = n // 2
    axis = axis % x.ndim
    size = x.shape[axis]
    idx = torch.arange(-r, size + r, device=x.device).clamp_(0, size - 1)
    xp = x.index_select(axis, idx)
    out = None
    for i in range(n):
        term = xp.narrow(axis, i, size) * weight[i]
        out = term if out is None else out + term
    return out


def gaussian_kernel_1d(sigma: float) -> "list[float]":
    """Normalised Gaussian weights, ``N = ceil(1.5 sigma) * 2 + 1`` taps,
    rounded to float32 as the JAX package stores them."""
    n = int(np.ceil(sigma * 3.0 / 2.0)) * 2 + 1
    t = np.linspace(-(n // 2), n // 2, n)
    w = np.exp(-(t**2) / (2.0 * sigma**2))
    w = (w / w.sum()).astype(np.float32)
    return [float(v) for v in w]


def gaussian_smooth(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian smoothing, replicate padding, last three axes."""
    w = gaussian_kernel_1d(sigma)
    for ax in (x.ndim - 3, x.ndim - 2, x.ndim - 1):
        x = filter1d(x, w, ax)
    return x


def kovesi_widths(sigma: float, n: int = 4) -> "list[int]":
    """Box widths of Kovesi's ``n``-box approximation of a Gaussian of
    ``sigma``; width-1 (identity) boxes are omitted."""
    w_ideal = np.sqrt(12 * sigma**2 / n + 1)
    w_u = int(np.ceil((w_ideal - 1) / 2) * 2 + 1)
    w_l = max(w_u - 2, 1)
    m = int(np.round((12 * sigma**2 - n * w_l**2 - 4 * n * w_l - 3 * n) / (-4 * w_l - 4)))
    widths: list[int] = []
    for _ in range(m):
        if w_l > 1:
            widths.append(w_l)
    for _ in range(n - m):
        widths.append(w_u)
    return widths


def kovesi_spline(x: torch.Tensor, sigma: float, n: int = 4) -> torch.Tensor:
    """Kovesi box cascade (zero padded, count-include-pad box filters)."""
    for w in kovesi_widths(sigma, n):
        x = avg_pool3d(x, w, stride=1, padding=(w - 1) // 2)
    return x
