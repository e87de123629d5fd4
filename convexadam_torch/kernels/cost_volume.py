"""Dense cost volume: wrappers of ``csrc/cost_volume.cu`` and their plain
versions.

Replaces ``convexadam_tpu/ops/cost_volume_pallas.py:cost_volume_pallas``
(SSD) and the XLA scans of ``convexadam_tpu/core/cost_volume.py:correlate``
(SAD) and ``core/convex.py:correlate_coupled_streamed`` (one candidate at a
time).  :func:`cost_volume` returns the unsmoothed volume (K^3, h, w, d) in
float32, flat layout ``k = kd*K^2 + kw*K + kh`` with ``K = 2q + 1``, zeros
outside the moving volume; ``metric`` is ``"ssd"`` (squared differences)
or ``"sad"`` (absolute ones).  :func:`cost_volume_block` computes the
candidates ``kh0 <= kh < kh0 + nkh`` only, as a (K^2 * nkh, h, w, d) slab of
index ``(kd*K + kw)*nkh + kh - kh0``: the streamed convex path's unit.  The
caller applies the box passes and the argmin.  Both take ``mov_row0``: the
moving features may hold other rows than the fixed ones, their first row at
the fixed features' row ``mov_row0``, with zeros outside them (a slab of a
volume split along h, :mod:`convexadam_torch.parallel.spatial`); the default
0 with equal shapes is the whole volume.

On the card, the half-widths the self-configuring search draws, q = 1..7,
run a kernel compiled for that q (:func:`kernel_for`); any other q (task
1's 8 among them) runs a general kernel with q at run time, which holds the
displacements kd in blocks (``csrc/cost_volume.cu``).  Each launch adds one
to one count of
:data:`~convexadam_torch.kernels.LAUNCHES`: ``cost_volume_block`` for a
block, else ``cost_volume_sad`` for SAD, else ``cost_volume`` (compiled
kernel) or ``cost_volume_general``.  The entry is bound once.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from convexadam_torch.kernels import LAUNCHES, _build

# csrc/cost_volume.cu compiles cost_volume_kernel<Q> for these Q: the
# disp_hw range of the self-configuring sweep
COMPILED_Q = range(1, 8)


def kernel_for(disp_hw: int) -> str:
    """The ``__global__`` function that computes a volume of half-width
    ``disp_hw`` on the card: the one compiled for it, or the general one."""
    return "cost_volume_kernel" if disp_hw in COMPILED_Q else "cost_volume_general_kernel"


METRICS = ("ssd", "sad")


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"cost metric {metric!r} not in {METRICS}")


def _metric_term(diff: torch.Tensor, metric: str) -> torch.Tensor:
    """One channel's term: the squared difference (SSD) or its magnitude
    (SAD, exact)."""
    return diff * diff if metric == "ssd" else diff.abs()


def _padded_moving(mov: torch.Tensor, q: int, h: int, mov_row0: int) -> torch.Tensor:
    """The moving features (C, hm, w, d) on the fixed rows ``-q .. h + q - 1``
    and padded by ``q`` along w and d, zeros outside them: (C, h + 2q, w +
    2q, d + 2q)."""
    C, hm, w, d = mov.shape
    if mov_row0 == 0 and hm == h:
        return F.pad(mov.float(), (q, q, q, q, q, q))
    out = mov.new_zeros((C, h + 2 * q, w + 2 * q, d + 2 * q), dtype=torch.float32)
    lo = -q - mov_row0  # the moving row at padded row 0
    a, b = max(lo, 0), min(lo + h + 2 * q, hm)
    if a < b:
        out[:, a - lo:b - lo, q:q + w, q:q + d] = mov[:, a:b].float()
    return out


def cost_volume_block_plain(
    fix: torch.Tensor, mov: torch.Tensor, disp_hw: int, kh0: int, nkh: int, metric: str = "ssd",
    mov_row0: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`cost_volume_block`: one ``kd`` plane
    of K * nkh shifts at a time, the channel sum taken channel by channel in
    float32 as the kernel does."""
    _check_metric(metric)
    q = disp_hw
    K = 2 * q + 1
    C, h, w, d = fix.shape
    fix = fix.float()
    movp = _padded_moving(mov, q, h, mov_row0)
    out = fix.new_empty((K * K * nkh, h, w, d))
    for kd in range(K):
        # (K * nkh, C, h, w, d) with kh fastest: index kw*nkh + kh - kh0
        slabs = torch.stack([
            movp[:, kh:kh + h, kw:kw + w, kd:kd + d]
            for kw in range(K) for kh in range(kh0, kh0 + nkh)
        ])
        diff = fix[None] - slabs
        acc = _metric_term(diff[:, 0], metric)
        for c in range(1, C):
            acc = acc + _metric_term(diff[:, c], metric)
        out[kd * K * nkh:(kd + 1) * K * nkh] = acc
    return out


def cost_volume_plain(
    fix: torch.Tensor, mov: torch.Tensor, disp_hw: int, metric: str = "ssd", mov_row0: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of :func:`cost_volume`: the block of every kh."""
    return cost_volume_block_plain(fix, mov, disp_hw, 0, 2 * disp_hw + 1, metric, mov_row0)


@functools.lru_cache(maxsize=None)
def _entry():
    P, I = _build.P, _build.I  # noqa: E741
    return _build.bind("cost_volume", "cost_volume", (P, P, P) + (I,) * 11 + (P,))


def _launch(fix, mov, disp_hw, kh0, nkh, metric, what, mov_row0):
    _check_metric(metric)
    _build.require_cuda(fix, what)
    _build.require(fix, f"{what} fix", (torch.float32,), (None,) * 4)
    _build.require(mov, f"{what} mov", (torch.float32,),
                   (fix.shape[0], None) + tuple(fix.shape[2:]))
    if mov.device != fix.device:
        raise ValueError(f"{what}: fix and mov must lie on one device")
    C, h, w, d = fix.shape
    K = 2 * disp_hw + 1
    if not 0 <= kh0 < kh0 + nkh <= K:
        raise ValueError(f"{what}: candidates kh {kh0}..{kh0 + nkh - 1} outside 0..{K - 1}")
    out = torch.empty((K * K * nkh, h, w, d), dtype=torch.float32, device=fix.device)
    general = kernel_for(disp_hw) == "cost_volume_general_kernel"
    err = _build.call_on(
        fix.device, _entry(), fix.data_ptr(), mov.data_ptr(), out.data_ptr(), C, h, w, d,
        disp_hw, int(general), int(metric == "sad"), kh0, nkh, mov.shape[1], mov_row0,
    )
    _build.check(err, what)
    return out, general


def _empty(fix: torch.Tensor, disp_hw: int, nkh: int) -> "torch.Tensor | None":
    """The (K^2 * nkh, h, w, d) output where it holds no value (a slab of no
    rows): an empty grid is no launch, nor a call of the plain version."""
    K = 2 * disp_hw + 1
    if fix.shape[1:].numel() == 0:
        return torch.empty((K * K * nkh,) + tuple(fix.shape[1:]), device=fix.device)
    return None


def cost_volume(
    fix: torch.Tensor, mov: torch.Tensor, disp_hw: int, metric: str = "ssd", mov_row0: int = 0
) -> torch.Tensor:
    """(K^3, h, w, d) float32 SSD or SAD volume of float32 features (C, h,
    w, d); the moving features (C, hm, w, d) begin at the fixed row
    ``mov_row0``."""
    if (out := _empty(fix, disp_hw, 2 * disp_hw + 1)) is not None:
        return out
    if fix.device.type == "cpu":
        return cost_volume_plain(fix, mov, disp_hw, metric, mov_row0)
    out, general = _launch(fix, mov, disp_hw, 0, 2 * disp_hw + 1, metric, "cost_volume",
                           mov_row0)
    if metric == "sad":
        LAUNCHES["cost_volume_sad"] += 1
    else:
        LAUNCHES["cost_volume_general" if general else "cost_volume"] += 1
    return out


def cost_volume_block(
    fix: torch.Tensor, mov: torch.Tensor, disp_hw: int, kh0: int, nkh: int, metric: str = "ssd",
    mov_row0: int = 0,
) -> torch.Tensor:
    """The candidates ``kh0 <= kh < kh0 + nkh`` of :func:`cost_volume`: a
    (K^2 * nkh, h, w, d) float32 slab, index ``(kd*K + kw)*nkh + kh - kh0``,
    each value the dense volume's to the bit."""
    if (out := _empty(fix, disp_hw, nkh)) is not None:
        return out
    if fix.device.type == "cpu":
        return cost_volume_block_plain(fix, mov, disp_hw, kh0, nkh, metric, mov_row0)
    out, _ = _launch(fix, mov, disp_hw, kh0, nkh, metric, "cost_volume_block", mov_row0)
    LAUNCHES["cost_volume_block"] += 1
    return out
