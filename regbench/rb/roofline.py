"""Peaks of the card and the least time a kernel's work could take.

Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet, dense
rates, at its 700 W power limit): 3.35 TB/s of HBM3 and 67 TFLOP/s of
float32 outside the tensor cores, an FMA counted as two operations, so
33.5 T of other float32 operations a second.  A share of a roofline is
stated against these, with the card's power limit beside it.
"""

from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops_per_s": 67e12,
    "fp32_unfused_ops_per_s": 33.5e12,
}


def cost_volume_work(channels: int, grid, disp_hw: int) -> "tuple[int, int]":
    """(bytes, operations) of one dense SSD cost volume of ``channels``
    float32 feature channels on the coarse ``grid`` (h, w, d) over ``K^3``
    displacements, ``K = 2 disp_hw + 1``: both feature volumes read once
    and the (K^3, h, w, d) float32 volume written once; a subtraction, a
    multiplication and an addition for every channel of every candidate
    (none fuses: the square is of the difference)."""
    n = 1
    for s in grid:
        n *= int(s)
    k3 = (2 * disp_hw + 1) ** 3
    nbytes = 4 * (2 * channels * n + k3 * n)
    ops = 3 * k3 * n * channels
    return nbytes, ops


def cost_volume_bound_s(channels: int, grid, disp_hw: int, peaks=H100_SXM) -> float:
    """The least seconds one cost volume could take on the card: the larger
    of its bytes over the memory bandwidth and its operations over the
    unfused float32 rate."""
    nbytes, ops = cost_volume_work(channels, grid, disp_hw)
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_unfused_ops_per_s"])
