"""The least time a launch of the coupled argmin's fold could take.

One launch (``coupled_argmin_fold``, ``convexadam_torch/kernels/convex.py``)
takes one round of the coupled convex optimisation over a cost volume of
``K^3`` candidates and ``n`` coarse voxels: it reads every float32 cost once
and writes one index a voxel.  Its bound is the cost bytes over the card's
memory bandwidth (PERF.md section 6, row 9: ``K^3 n 4`` bytes over 3.35
TB/s; the index writes, the field it couples to and the eleven unfused
operations a candidate fall well below it)."""

from __future__ import annotations

from rb.roofline import H100_SXM


def fold_bytes(candidates: int, voxels: int) -> int:
    """Bytes of float32 costs one launch reads: ``K^3 n 4``."""
    return 4 * int(candidates) * int(voxels)


def fold_bound_s(candidates: int, voxels: int, peaks=H100_SXM) -> float:
    """The least seconds one launch could take on the card."""
    return fold_bytes(candidates, voxels) / peaks["hbm_bytes_per_s"]
