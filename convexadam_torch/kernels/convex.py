"""The convex stage's coupled argmin: the wrapper of ``csrc/convex.cu`` and
its plain version.

Replaces no Pallas kernel: the JAX package's coupled argmin
(``convexadam_tpu/core/convex.py``) is XLA.  :func:`coupled_argmin_fold`
folds a block of ``k`` candidates into a running per-voxel first minimum:
for every voxel ``v`` and candidate ``j``, ``val = costs[j, v] + c * ((sq0
+ sq1) + sq2)`` with ``sq_i = (mesh[i, j] - s[i, v])^2`` (:func:`coupled_cost`,
each operation rounded in float32 as PyTorch rounds it), and ``(val,
idx[j])`` replaces ``(best[v], bidx[v])`` where it comes first in
``torch.argmin``'s order (:func:`first_min`).  ``idx`` increases with
``j``; blocks may come in any order.  The dense convex path folds all K^3
candidates at once from ``(inf, K^3)``, the streamed path one block of K^2
candidates at a time, the tensor-parallel path a rank's slice
(``core/convex.py``).

On the card each call is one launch of ``coupled_argmin_fold_kernel<VEC>``
whose shape :func:`launch_plan` takes from ``(n, k)`` and the costs'
alignment; it adds one to ``LAUNCHES["coupled_argmin"]`` and counts
``coupled_argmin.kernel`` in the program's record
(:mod:`convexadam_torch.utils.trace`).  CPU tensors take the plain version
and count ``coupled_argmin.plain``.  No call makes the host wait.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from convexadam_torch.kernels import LAUNCHES, _build
from convexadam_torch.utils import trace

# bytes of one (3, k, chunk) float32 temporary of the plain version: at the
# sweep's largest dense setting (K^3 = 1331, 983,040 coarse voxels) the
# unchunked difference and its square took 15.7 GB each
COUPLED_CHUNK_BYTES = 1 << 30

# warps a launch should offer each SM, below which a block's warps split the
# candidates.  Not a count of waves: an SM holds 24 warps of the VEC-4 kernel
# (70 registers, three blocks of 256 threads) and 64 of the VEC-1 kernel; 128
# came out of timing every (vec, splits) at every class of the benchmark's
# cells on an H100 (scripts/time_coupled_fold.py): the best shape or within
# 4% of it at every class of 1 GB of costs or more, up to 28% off below
WARPS_PER_SM = 128
SPLITS = (1, 2, 4, 8)


def coupled_cost(costs, mesh, s, c):
    """``costs + c * ((sq0 + sq1) + sq2)`` of candidates ``costs`` (k, m)
    at displacements ``mesh`` (3, k) against the smoothed field ``s`` (3,
    m): the one form every path compares, so their fields agree to the
    bit."""
    diff = mesh[:, :, None] - s[:, None, :]  # (3, k, m)
    sq = diff * diff
    del diff
    return costs + c * (sq[0] + sq[1] + sq[2])


def first_min(best, bidx, val, idx):
    """Fold candidates ``val`` with indices ``idx`` into the running
    ``(best, bidx)`` in ``torch.argmin``'s order: a NaN first (the smaller
    index among NaNs), then the smaller value, then the smaller index; so
    the result is ``argmin``'s first minimum over every candidate whatever
    order the blocks come in."""
    vn, bn = torch.isnan(val), torch.isnan(best)
    earlier = idx < bidx
    better = torch.where(vn | bn, vn & (~bn | earlier), (val < best) | ((val == best) & earlier))
    return torch.where(better, val, best), torch.where(better, idx, bidx)


def coupled_argmin_fold_plain(costs, mesh, idx, s, c, best, bidx):
    """Plain PyTorch version of :func:`coupled_argmin_fold`:
    :func:`coupled_cost` in chunks of voxels whose (3, k, chunk) float32
    temporaries take at most :data:`COUPLED_CHUNK_BYTES`, each chunk's
    first minimum (``torch.min``) folded by :func:`first_min`.  No voxel's
    arithmetic depends on the chunking."""
    k, n = costs.shape
    chunk = max(1, COUPLED_CHUNK_BYTES // (3 * k * 4))
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        val, arg = torch.min(coupled_cost(costs[:, a:b], mesh, s[:, a:b], c), dim=0)
        best[a:b], bidx[a:b] = first_min(best[a:b], bidx[a:b], val, idx[arg])
    return best, bidx


def launch_plan(n: int, k: int, aligned: bool, sms: int) -> "tuple[int, int]":
    """``(vec, splits)`` of a launch over ``n`` voxels and ``k`` candidates
    on a card of ``sms`` SMs: 4 voxels a thread (16-byte loads) where the
    costs are ``aligned`` (a 16-byte pointer and a row stride of whole
    float4s), else 1; and the fewest candidate splits a block
    (:data:`SPLITS`) that offer :data:`WARPS_PER_SM` warps an SM, each split
    keeping at least 32 candidates."""
    vec = 4 if aligned else 1
    warps = -(-n // (32 * vec))
    for splits in SPLITS:
        if warps * splits >= WARPS_PER_SM * sms or k < 64 * splits:
            break
    return vec, splits


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of the card ``device`` (read once a card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _entry():
    P, I, F = _build.P, _build.I, _build.F  # noqa: E741
    return _build.bind("convex", "coupled_argmin_fold",
                       (P, ctypes.c_longlong, P, P, P, F, P, P, I, I, I, I, P))


def _launch(costs, mesh, idx, s, c, best, bidx, vec, splits):
    what = "coupled_argmin_fold"
    k, n = costs.shape
    _build.require_cuda(costs, what)
    if costs.dtype != torch.float32 or costs.stride(1) != 1:
        raise ValueError(f"{what}: costs must be float32 rows of unit stride, got "
                         f"{costs.dtype} with strides {costs.stride()}")
    _build.require(mesh, f"{what} mesh", (torch.float32,), (3, k))
    _build.require(idx, f"{what} idx", (torch.int64,), (k,))
    _build.require(s, f"{what} s", (torch.float32,), (3, n))
    _build.require(best, f"{what} best", (torch.float32,), (n,))
    _build.require(bidx, f"{what} bidx", (torch.int64,), (n,))
    if any(t.device != costs.device for t in (mesh, idx, s, best, bidx)):
        raise ValueError(f"{what}: every tensor must lie on the costs' device")
    err = _build.call_on(
        costs.device, _entry(), costs.data_ptr(), costs.stride(0), mesh.data_ptr(),
        idx.data_ptr(), s.data_ptr(), float(c), best.data_ptr(), bidx.data_ptr(), k, n, vec,
        splits,
    )
    _build.check(err, what)


def coupled_argmin_fold(costs, mesh, idx, s, c, best, bidx):
    """Fold the candidates ``costs`` (k, n), float32 rows of unit stride
    (any row stride), at displacements ``mesh`` (3, k) with increasing
    indices ``idx`` (k,) int64, coupled by ``c`` to the field ``s`` (3, n),
    into the running first minimum ``best`` (n,) float32 / ``bidx`` (n,)
    int64, in place (module docstring).  Returns ``(best, bidx)``; no
    candidate or no voxel is no launch."""
    k, n = costs.shape
    if k == 0 or n == 0:
        return best, bidx
    mesh, idx, s = mesh.contiguous(), idx.contiguous(), s.contiguous()
    if costs.device.type == "cpu":
        trace.count("coupled_argmin.plain")
        return coupled_argmin_fold_plain(costs, mesh, idx, s, c, best, bidx)
    aligned = costs.data_ptr() % 16 == 0 and costs.stride(0) % 4 == 0
    _launch(costs, mesh, idx, s, c, best, bidx,
            *launch_plan(n, k, aligned, sm_count(costs.device)))
    LAUNCHES["coupled_argmin"] += 1
    trace.count("coupled_argmin.kernel")
    return best, bidx
