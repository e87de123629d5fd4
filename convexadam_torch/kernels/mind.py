"""MIND-SSC statistics: wrapper of ``csrc/mind.cu`` and its plain version.

Replaces ``convexadam_tpu/ops/mind_pallas.py:mind_ssd_stats_pallas``.  On the
card the radii and dilations in {1, 2, 3} run a kernel compiled for that
pair (:func:`kernel_for`), any other pair r, d >= 0 the general kernel with
both at run time, staged as :func:`general_plan` chooses.  Both versions
return ``mind = boxmean(diff^2) - min_c`` (12, H, W, D) in the
input dtype and ``var = mean_c(mind)`` (H, W, D) in float32: everything of
MIND-SSC before the global-mean variance clamp.  A launch adds one to
``mind_ssd_stats`` (compiled kernel) or ``mind_ssd_stats_general`` of
:data:`~convexadam_torch.kernels.LAUNCHES`.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from convexadam_torch.core.smoothing import _window_sum_axis, replicate_pad3d
from convexadam_torch.kernels import LAUNCHES, _build

DTYPES = (torch.float32, torch.bfloat16)

# csrc/mind.cu compiles mind_kernel<T, R, DIL> for these (R, DIL): the radii
# and dilations of the self-configuring search
COMPILED_PAIRS = frozenset((r, d) for r in (1, 2, 3) for d in (1, 2, 3))
# the output tile of both kernels (csrc/mind.cu: FH, FW, FD) and the dynamic
# shared memory an H100 gives one CTA
TILE = (4, 8, 64)
SMEM_PER_BLOCK = 232448


def kernel_for(radius: int, dilation: int) -> str:
    """The ``__global__`` function that computes ``(radius, dilation)`` on
    the card: the one compiled for the pair, or the general one."""
    return "mind_kernel" if (radius, dilation) in COMPILED_PAIRS else "mind_general_kernel"


def general_plan(radius: int, dilation: int, itemsize: int) -> "tuple[bool, int, int]":
    """``(halo, cw, smem_bytes)`` of the general kernel for elements of
    ``itemsize`` bytes: the image halo staged in shared memory where it fits
    beside the H and W sums of the whole region (``cw`` = its FW + 2r
    columns) and the box means; else the operands read from
    global memory and the H sums taken in chunks of ``cw`` columns, as many
    as fit (``csrc/mind.cu``: ``general_smem``)."""
    fh, fw, fd = TILE
    b, ep, ew = radius + dilation, fd // 2 + radius, fw + 2 * radius
    pair = 2 * itemsize
    fixed = pair * (fh * ep * fw + 12 * 2 * fh * fw * fd // 4)
    halo = -(-(fh + 2 * b) * (fw + 2 * b) * (fd + 2 * b) * itemsize // 16) * 16
    column = pair * fh * ep
    if halo + fixed + column * ew <= SMEM_PER_BLOCK:
        return True, ew, halo + fixed + column * ew
    cw = min(ew, (SMEM_PER_BLOCK - fixed) // column)
    if cw < 1:
        raise ValueError(f"mind_ssd_stats: radius {radius} needs more shared memory than a CTA has")
    return False, cw, fixed + column * cw


def _mind_shift_pairs() -> "list[tuple[tuple[int, int, int], tuple[int, int, int]]]":
    """The 12 ordered shift pairs of the MIND-SSC pattern: the ordered pairs
    (x > y in row-major order) of six-neighbourhood offsets of a 3x3x3 patch
    at squared distance 2, relative to the patch corner."""
    six = [(0, 1, 1), (1, 1, 0), (1, 0, 1), (1, 1, 2), (2, 1, 1), (1, 2, 1)]
    ordered = []
    for x in range(6):
        for y in range(6):
            d = sum((a - b) ** 2 for a, b in zip(six[x], six[y]))
            if x > y and d == 2:
                ordered.append((six[x], six[y]))
    assert len(ordered) == 12
    return ordered


def _pair_offsets(dilation: int):
    """The 12 pairs as voxel offsets from the centre, scaled by ``dilation``."""
    return [
        (tuple((c - 1) * dilation for c in s1), tuple((c - 1) * dilation for c in s2))
        for s1, s2 in _mind_shift_pairs()
    ]


def shifted_replicate(img: torch.Tensor, offset: Sequence[int]) -> torch.Tensor:
    """``out[x] = img[clamp(x + offset)]`` over the last three axes."""
    for k, o in enumerate(offset):
        if o == 0:
            continue
        ax = img.ndim - 3 + k
        n = img.shape[ax]
        idx = (torch.arange(n, device=img.device) + int(o)).clamp_(0, n - 1)
        img = img.index_select(ax, idx)
    return img


def _true_div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v`` as one IEEE float32 division rounded to ``x``'s dtype, on
    every device.  A Python scalar divisor may be turned into a
    multiplication by its reciprocal, which rounds differently; a
    one-element float32 tensor divisor never is (and stays exact where
    bfloat16 could not hold ``v``, e.g. 343)."""
    div = torch.full((1,) * x.ndim, v, dtype=torch.float32, device=x.device)
    return (x / div).to(x.dtype)


def mind_ssd_stats_plain(x: torch.Tensor, radius: int, dilation: int):
    """Plain PyTorch version, in the kernel's order and rounding: squared
    shift differences, replicate-padded box sums along H, W, D with offsets
    added in ascending order, the channel min, and the channel sum of
    ``mind`` in float32 taken channel by channel."""
    diffs = []
    for o1, o2 in _pair_offsets(dilation):
        d = shifted_replicate(x, o1) - shifted_replicate(x, o2)
        diffs.append(d * d)
    k = 2 * radius + 1
    ssd = replicate_pad3d(torch.stack(diffs), radius)
    for ax in (1, 2, 3):
        ssd = _window_sum_axis(ssd, ax, k, 1, 0)
    ssd = _true_div(ssd, float(k**3))
    mind = ssd - ssd.min(dim=0).values
    var = mind[0].float()
    for c in range(1, mind.shape[0]):
        var = var + mind[c].float()
    return mind, _true_div(var, float(mind.shape[0]))


@functools.lru_cache(maxsize=None)
def _entry():
    P, I = _build.P, _build.I  # noqa: E741
    return _build.bind("mind", "mind_ssd_stats", (P, P, P, I, I, I, I, I, I, I, I, I, P))


def mind_ssd_stats(x: torch.Tensor, radius: int, dilation: int):
    """(mind, var) of the volume ``x`` (H, W, D), float32 or bfloat16, at
    any ``radius`` and ``dilation`` >= 0 (on the card a radius up to 433 in
    float32 and 1240 in bfloat16: :func:`general_plan`)."""
    if radius < 0 or dilation < 0:
        raise ValueError(f"mind_ssd_stats: radius {radius} and dilation {dilation} must be >= 0")
    if x.numel() == 0:  # a slab of no rows: no launch
        return (torch.empty((12,) + tuple(x.shape), dtype=x.dtype, device=x.device),
                torch.empty(x.shape, device=x.device))
    if x.device.type == "cpu":
        return mind_ssd_stats_plain(x, radius, dilation)
    _build.require_cuda(x, "mind_ssd_stats")
    _build.require(x, "mind_ssd_stats x", DTYPES, (None, None, None))
    H, W, D = x.shape
    mind = torch.empty((12, H, W, D), dtype=x.dtype, device=x.device)
    var = torch.empty((H, W, D), dtype=torch.float32, device=x.device)
    general = kernel_for(radius, dilation) == "mind_general_kernel"
    halo, cw, _ = general_plan(radius, dilation, x.element_size()) if general else (False, 0, 0)
    err = _build.call_on(
        x.device, _entry(), x.data_ptr(), mind.data_ptr(), var.data_ptr(), H, W, D, radius,
        dilation, int(general), int(halo), cw, int(x.dtype == torch.bfloat16),
    )
    _build.check(err, "mind_ssd_stats")
    LAUNCHES["mind_ssd_stats_general" if general else "mind_ssd_stats"] += 1
    return mind, var
