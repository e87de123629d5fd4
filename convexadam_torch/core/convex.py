"""Coupled convex optimisation, the global discrete regulariser.

Counterpart of ``coupled_convex`` (exact form), ``correlate_coupled_streamed``,
``convex_displacement`` and ``convex_displacement_tp`` in
``convexadam_tpu/core/convex.py``.  Starting
from the box-smoothed argmin field, six rounds with growing coupling ``c``
pick, per coarse voxel, the displacement minimising ``ssd[k] + c *
||d_k - disp_soft||^2`` and box-smooth the picked field.  The dense form
holds the whole (K^3, h, w, d) cost volume; the streamed form makes it again
in blocks of K^2 candidates for the initial argmin and for each coupling,
keeping only a running (best, argmin).  The tensor-parallel form spreads the
candidates over the ranks of a process group and finds each voxel's first
minimum with two collective minima a round.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from convexadam_torch.core.cost_volume import correlate, displacement_mesh
from convexadam_torch.core.smoothing import avg_pool3d, window_mean3d
from convexadam_torch.kernels.cost_volume import cost_volume_block

COUPLING_COEFFS = (0.003, 0.01, 0.03, 0.1, 0.3, 1.0)

# Dense cost volumes whose estimated footprint (the float32 volume plus one
# smoothing temporary, i.e. twice the raw volume, K^3 n 4 2 bytes) exceeds
# this many bytes take the streamed path.  Derived for one 80 GB H100
# (NVIDIA H100 80GB HBM3, 700 W): at the (grid_sp 2, disp_hw 7) class at 192
# x 160 x 256 (983,040 coarse voxels) the dense path's peak
# (torch.cuda.max_memory_allocated) rose 26.54 GB above what was held before
# it, 1.0000 times the 26.54 GB estimate (chip_smoke.py phase 7e; the 1 GB
# coupled-argmin chunks fit in the freed first volume).  A dense run at 64 GB
# then peaks at 64 GB plus what the caller holds (features, fields: under 6
# GB at these sizes), under 70 GB of the 80 (PERF.md section 5).
COST_VOLUME_STREAM_THRESHOLD = 64_000_000_000

# bytes of one (3, K^3, chunk) float32 temporary of the coupled argmin: at
# the sweep's largest dense setting (K^3 = 1331, 983,040 coarse voxels) the
# unchunked difference and its square took 15.7 GB each
COUPLED_CHUNK_BYTES = 1 << 30


def _gather_disp(disp_mesh: torch.Tensor, argmin: torch.Tensor) -> torch.Tensor:
    """disp_mesh (3, K^3) at argmin (h, w, d) → field (3, h, w, d)."""
    return disp_mesh[:, argmin.reshape(-1)].reshape((3,) + tuple(argmin.shape))


def _coupled_cost(costs, mesh, s, c):
    """``costs + c * ((sq0 + sq1) + sq2)`` of candidates ``costs`` (k,
    chunk) at displacements ``mesh`` (3, k) against the smoothed field
    ``s`` (3, chunk): the one form both the dense and the streamed path
    compare, so their fields agree to the bit."""
    diff = mesh[:, :, None] - s[:, None, :]  # (3, k, chunk)
    sq = diff * diff
    del diff
    return costs + c * (sq[0] + sq[1] + sq[2])


def _coupled_argmin(ssd_flat, disp_mesh, s, c, chunk):
    """Per coarse voxel the first displacement minimising
    :func:`_coupled_cost`, ``chunk`` voxels at a time: the (3, K^3, chunk)
    temporaries stay bounded, and no voxel's arithmetic depends on the
    chunking."""
    n = ssd_flat.shape[1]
    out = torch.empty(n, dtype=torch.int64, device=ssd_flat.device)
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        out[a:b] = torch.argmin(_coupled_cost(ssd_flat[:, a:b], disp_mesh, s[:, a:b], c), dim=0)
    return out


def box3(field: torch.Tensor) -> torch.Tensor:
    """The coupling's zero-padded 3^3 box pass of a picked field (3, h, w,
    d)."""
    return avg_pool3d(field, 3, stride=1, padding=1)


def coupled_convex(
    ssd: torch.Tensor, ssd_argmin: torch.Tensor, disp_mesh: torch.Tensor, smooth=box3
) -> torch.Tensor:
    """Solve the coupled convex problem in its exact form.

    ``ssd`` (K^3, h, w, d), ``ssd_argmin`` (h, w, d), ``disp_mesh``
    (3, K^3).  Returns ``disp_soft`` (3, h, w, d) in coarse voxels.  The
    coupled argmin runs over chunks of voxels whose (3, K^3, chunk) float32
    difference takes at most :data:`COUPLED_CHUNK_BYTES`.  ``smooth`` is the
    box pass of each picked field (a slab of a volume split along h passes
    one that takes its neighbours' rows).
    """
    shape = ssd.shape[1:]
    ssd_flat = ssd.reshape(ssd.shape[0], -1)
    chunk = max(1, COUPLED_CHUNK_BYTES // (3 * ssd.shape[0] * 4))
    disp_soft = smooth(_gather_disp(disp_mesh, ssd_argmin))
    for c in COUPLING_COEFFS:
        s = disp_soft.reshape(3, -1)
        argmin = _coupled_argmin(ssd_flat, disp_mesh, s, c, chunk).reshape(shape)
        disp_soft = smooth(_gather_disp(disp_mesh, argmin))
    return disp_soft


def _first_min(best, bidx, val, idx):
    """Fold candidates ``val`` with global indices ``idx`` into the running
    ``(best, bidx)``: a smaller value wins, an equal one only with a smaller
    index, so the result is ``argmin``'s first minimum over every candidate
    whatever order the blocks come in."""
    better = (val < best) | ((val == best) & (idx < bidx))
    return torch.where(better, val, best), torch.where(better, idx, bidx)


def correlate_coupled_streamed(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hw: int,
    metric: str = "ssd",
    smooth_passes: int = 2,
    mov_row0: int = 0,
    rows: "tuple[int, int] | None" = None,
    smooth=box3,
) -> torch.Tensor:
    """Cost volume + coupled convex without the (K^3, h, w, d) volume.

    The smoothed costs come in blocks of K^2 candidates, one ``kh`` each
    (:func:`~convexadam_torch.kernels.cost_volume.cost_volume_block`, the
    same box passes as :func:`correlate`, which round each candidate's slice
    as they do inside the whole volume), made again for the initial argmin
    and for each of the six couplings: a running (best, argmin) is all that
    is kept, so peak memory is one block's costs and its temporaries, and
    the cost volume is computed 7 times.  Each coupled cost is the dense
    form's (:func:`_coupled_cost`), and :func:`_first_min` keeps
    the first minimum, so the field equals :func:`coupled_convex` on the
    dense volume to the bit.  ``mov_row0``, ``rows`` and ``smooth`` are
    :func:`convex_displacement`'s.

    Returns ``disp_soft`` (3, h, w, d) in coarse voxels.
    """
    q = disp_hw
    K = 2 * q + 1
    fix = feat_fix.float().contiguous()
    mov = feat_mov.float().contiguous()
    lo, hi = rows or (0, fix.shape[1])
    shape = (hi - lo,) + tuple(fix.shape[2:])
    n = shape[0] * shape[1] * shape[2]
    dev = fix.device
    mesh = displacement_mesh(q, device=dev)
    # the global index kd*K^2 + kw*K + kh of a block's candidate kd*K + kw
    local = torch.arange(K * K, device=dev) * K
    chunk = max(1, COUPLED_CHUNK_BYTES // (3 * K * K * 4))

    def block(kh):
        costs = cost_volume_block(fix, mov, q, kh, 1, metric, mov_row0)
        for _ in range(smooth_passes):
            costs = window_mean3d(costs, 3, stride=1, padding=1)
        return costs[:, lo:hi].reshape(K * K, n), local + kh

    def argmin_pass(s=None, c=None):
        best = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        bidx = torch.full((n,), K**3, dtype=torch.int64, device=dev)
        for kh in range(K):
            costs, idx = block(kh)
            mesh_b = mesh[:, idx]
            for a in range(0, n, chunk):
                b = min(a + chunk, n)
                if s is None:
                    val, arg = torch.min(costs[:, a:b], dim=0)
                else:
                    val, arg = torch.min(_coupled_cost(costs[:, a:b], mesh_b, s[:, a:b], c), dim=0)
                best[a:b], bidx[a:b] = _first_min(best[a:b], bidx[a:b], val, idx[arg])
            del costs
        return bidx.reshape(shape)

    disp_soft = smooth(_gather_disp(mesh, argmin_pass()))
    for c in COUPLING_COEFFS:
        am = argmin_pass(disp_soft.reshape(3, -1), c)
        disp_soft = smooth(_gather_disp(mesh, am))
    return disp_soft


def dense_estimate(disp_hw: int, coarse_shape) -> int:
    """Bytes the dense path is reckoned to hold: the float32 (K^3, h, w, d)
    volume, and the larger of one smoothing temporary of its size and the
    coupled argmin's two (3, K^3, chunk) float32 temporaries (the
    difference and its square, :func:`_coupled_cost`; they outweigh the
    volume below about 2 GB)."""
    n = 1
    for s in coarse_shape:
        n *= int(s)
    k3 = (2 * disp_hw + 1) ** 3
    volume = k3 * n * 4
    chunk = min(n, max(1, COUPLED_CHUNK_BYTES // (3 * k3 * 4)))
    return volume + max(volume, 2 * 3 * k3 * chunk * 4)


def convex_displacement(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hw: int,
    metric: str = "ssd",
    smooth_passes: int = 2,
    stream_threshold: int = COST_VOLUME_STREAM_THRESHOLD,
    mov_row0: int = 0,
    rows: "tuple[int, int] | None" = None,
    smooth=box3,
) -> torch.Tensor:
    """One convex-stage direction: cost volume + coupled convex, taking
    :func:`correlate_coupled_streamed` where the dense estimate
    (:func:`dense_estimate`) exceeds ``stream_threshold`` bytes.  Both give
    the same field, to the bit.

    A slab of a volume split along h (:mod:`convexadam_torch.parallel.spatial`)
    passes its fixed rows grown by the box passes' reach, the moving rows
    grown by ``disp_hw`` more from the fixed row ``mov_row0``, the rows
    ``(lo, hi)`` of the fixed slab it owns, and a ``smooth`` that takes its
    neighbours' rows; the field then covers the owned rows."""
    kw = dict(metric=metric, smooth_passes=smooth_passes, mov_row0=mov_row0, rows=rows)
    if dense_estimate(disp_hw, feat_fix.shape[1:]) > stream_threshold:
        return correlate_coupled_streamed(feat_fix, feat_mov, disp_hw, smooth=smooth, **kw)
    ssd, am = correlate(feat_fix, feat_mov, disp_hw, **kw)
    return coupled_convex(ssd, am, displacement_mesh(disp_hw, device=ssd.device), smooth)


def _candidate_costs(fix, mov, disp_hw, lo, hi, metric):
    """The unsmoothed costs of the candidates ``lo <= k < hi`` of the flat
    order ``k = kd*K^2 + kw*K + kh``, as (hi - lo, h, w, d): one
    :func:`~convexadam_torch.kernels.cost_volume.cost_volume_block` call on
    the features with their spatial axes reversed, which makes the block's
    ``kh`` range a range of ``kd`` planes; each value is the dense volume's,
    to the bit (the same channel sum, at other addresses)."""
    K = 2 * disp_hw + 1
    kd0, kd1 = lo // (K * K), (hi - 1) // (K * K) + 1
    rev = (0, 3, 2, 1)
    slab = cost_volume_block(fix.permute(rev).contiguous(), mov.permute(rev).contiguous(),
                             disp_hw, kd0, kd1 - kd0, metric)
    # (kh, kw, kd - kd0, d, w, h) → (kd - kd0, kw, kh, h, w, d)
    n = kd1 - kd0
    slab = slab.reshape((K, K, n) + tuple(slab.shape[1:])).permute(2, 1, 0, 5, 4, 3)
    slab = slab.reshape((K * K * n,) + tuple(fix.shape[1:]))
    return slab[lo - kd0 * K * K:hi - kd0 * K * K].contiguous()


def convex_displacement_tp(
    feat_fix: torch.Tensor,
    feat_mov: torch.Tensor,
    disp_hw: int,
    group=None,
    metric: str = "ssd",
    smooth_passes: int = 2,
) -> torch.Tensor:
    """Tensor-parallel convex stage: the (2q+1)^3 candidates spread over
    the ranks of the process group ``group`` (``torch.distributed.group.WORLD``
    for every rank; ``None``: this rank alone holds them all), each rank
    holding only its slice of the cost volume.

    Rank r of n takes the contiguous candidates ``[r*m, (r+1)*m)``, ``m =
    ceil(K^3 / n)``, of the list padded with the last candidate (as the JAX
    package pads): a padded copy of candidate K^3 - 1 changes neither a
    minimum nor its first index, so each rank evaluates only its distinct
    candidates, and a rank whose slice is all padding evaluates K^3 - 1.
    The costs, their box passes and each round's coupled cost are the dense
    path's (:func:`correlate`, :func:`_coupled_cost`); per round two
    collective minima recover every voxel's global first minimum, the value
    first, then the smallest index among the ranks that hold it.  The field
    therefore equals :func:`convex_displacement`'s to the bit, on every rank.
    ``feat_fix``/``feat_mov`` (C, h, w, d) lie on this rank's device.

    Returns ``disp_soft`` (3, h, w, d) in coarse voxels.
    """
    n_ranks, r = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    q = disp_hw
    K3 = (2 * q + 1) ** 3
    m = -(-K3 // n_ranks)
    lo, hi = min(r * m, K3 - 1), min((r + 1) * m, K3)
    fix = feat_fix.float().contiguous()
    mov = feat_mov.float().contiguous()
    shape = tuple(fix.shape[1:])
    n = fix[0].numel()
    dev = fix.device
    costs = _candidate_costs(fix, mov, q, lo, hi, metric)
    for _ in range(smooth_passes):
        costs = window_mean3d(costs, 3, stride=1, padding=1)
    costs = costs.reshape(hi - lo, n)
    mesh = displacement_mesh(q, device=dev)
    ks = torch.arange(lo, hi, device=dev)
    mesh_l = mesh[:, ks]
    chunk = max(1, COUPLED_CHUNK_BYTES // (3 * (hi - lo) * 4))

    def global_argmin(s=None, c=None):
        val = torch.empty(n, dtype=torch.float32, device=dev)
        idx = torch.empty(n, dtype=torch.int64, device=dev)
        for a in range(0, n, chunk):
            b = min(a + chunk, n)
            block = costs[:, a:b] if s is None else _coupled_cost(costs[:, a:b], mesh_l,
                                                                    s[:, a:b], c)
            v, i = torch.min(block, dim=0)
            val[a:b], idx[a:b] = v, ks[i]
        if n_ranks == 1:
            return idx.reshape(shape)
        gmin = val.clone()
        dist.all_reduce(gmin, op=dist.ReduceOp.MIN, group=group)
        cand = torch.where(val == gmin, idx, torch.full_like(idx, K3))
        dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
        return cand.reshape(shape)

    disp_soft = avg_pool3d(_gather_disp(mesh, global_argmin()), 3, stride=1, padding=1)
    for c in COUPLING_COEFFS:
        am = global_argmin(disp_soft.reshape(3, -1), c)
        disp_soft = avg_pool3d(_gather_disp(mesh, am), 3, stride=1, padding=1)
    return disp_soft
