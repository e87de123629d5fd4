"""Nearest-neighbour searches of the HD95 engine: wrappers of ``csrc/edt.cu``
and their plain versions.

* :func:`nearest_sq` replaces
  ``convexadam_tpu/ops/edt_pallas.py:nearest_sq_pallas``;
* :func:`nearest_sq_dual` replaces ``nearest_sq_dual_pallas``;
* :func:`nearest_sq_pruned` replaces ``nearest_sq_pruned_pallas``.

Points are (3, K) float32 rows of integer coordinates below 1024 in array
order; buffer tails hold :data:`COORD_PAD`.  The squared distance of two
real points is an integer below 2^24 and every product and partial sum on
the way is too, so it is exact in float32 in any order of operations: the
kernels and the plain versions agree bit for bit at every meaningful entry.

Meaningful entries (outside them the values are not meaningful, as in the
JAX package, and callers mask them):

* :func:`nearest_sq`: queries ``[0, n_query)``, each the least squared
  distance to the targets ``[0, n_target)`` (:data:`ACC_INIT` when there
  are none);
* :func:`nearest_sq_dual`: the same per query in ``[head_query, n_query)``
  and per target in ``[head_target, n_target)`` (the min over queries
  ``[0, n_query)``); the (head_query x head_target) corner is dead;
* :func:`nearest_sq_pruned`: queries ``[q_lo, q_hi)``.

The counts may be Python ints or one-element integer tensors (the engine
passes them on the card, so nothing waits for the host).  The pruned
search's block bounding boxes, their ascending order and the sorted bounds
(:func:`pruned_block_order`) are plain PyTorch, shared by the wrapper and
the plain version.
"""

from __future__ import annotations

import torch

from convexadam_torch.kernels import LAUNCHES, _build

COORD_PAD = 8192.0  # padded points: distance² ≥ (8192 - 1024)², never wins
ACC_INIT = 4.0 * COORD_PAD * COORD_PAD  # above any distance involving a pad
#: queries per CTA and targets per shared-memory tile of the tiled and dual kernels
TILE = 256
#: query and target block of the pruned search
PRUNED_BLOCK = 128


def _count(v, default: int, device: torch.device) -> torch.Tensor:
    """A count as a (1,) int32 tensor on ``device``."""
    if v is None:
        v = default
    if isinstance(v, torch.Tensor):
        return v.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(v)], dtype=torch.int32, device=device)


def _sq_dist(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(a, b) squared distances of the points (3, a) to the points (3, b)."""
    qn = (q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]
    tn = (t[0] * t[0] + t[1] * t[1]) + t[2] * t[2]
    return (tn[None, :] + qn[:, None]) - 2.0 * (q.T @ t)


def _chunk(kq: int) -> int:
    return max(256, min(4096, (1 << 24) // max(kq, 1)))


def _check(what: str, *pts: torch.Tensor) -> None:
    _build.require_cuda(pts[0], what)
    for p in pts:
        _build.require(p, what, (torch.float32,), (3, None))
        if p.device != pts[0].device:
            raise ValueError(f"{what}: all tensors must lie on one device")


# ---------------------------------------------------------------------------
# nearest_sq
# ---------------------------------------------------------------------------

def nearest_sq_plain(query, target, n_query=None, n_target=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`nearest_sq`; queries at or past
    ``n_query`` hold :data:`ACC_INIT`."""
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    nq, nt = _count(n_query, kq, dev), _count(n_target, kt, dev)
    best = torch.full((kq,), ACC_INIT, dtype=torch.float32, device=dev)
    tidx = torch.arange(kt, device=dev)
    step = _chunk(kq)
    for c0 in range(0, kt, step):
        d = _sq_dist(query, target[:, c0:c0 + step])
        d = torch.where((tidx[c0:c0 + step] < nt)[None, :], d, torch.inf)
        best = torch.minimum(best, d.amin(1))
    return torch.where(torch.arange(kq, device=dev) < nq, best, ACC_INIT)


def nearest_sq(query, target, n_query=None, n_target=None) -> torch.Tensor:
    """Per query point (3, Kq), the least squared distance to the target
    points (3, Kt) ``[0, n_target)`` → (Kq,) float32."""
    if query.device.type == "cpu":
        return nearest_sq_plain(query, target, n_query, n_target)
    _check("nearest_sq", query, target)
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    nq, nt = _count(n_query, kq, dev), _count(n_target, kt, dev)
    out = torch.empty((kq,), dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind("edt", "nearest_sq", [P, P, P, I, I, P, P, I, P])
    err = _build.call_on(
        dev, fn, query.data_ptr(), target.data_ptr(), out.data_ptr(), kq, kt, nq.data_ptr(),
        nt.data_ptr(), TILE,
    )
    _build.check(err, "nearest_sq")
    LAUNCHES["nearest_sq"] += 1
    return out


# ---------------------------------------------------------------------------
# nearest_sq_dual
# ---------------------------------------------------------------------------

def nearest_sq_dual_plain(query, target, n_query=None, n_target=None, head_query=None,
                          head_target=None):
    """Plain PyTorch version of :func:`nearest_sq_dual`: both directions
    from one pass over the same distance chunks.  It evaluates the dead
    corner too (``head_*`` only say which entries are meaningful); entries
    at or past the counts hold :data:`ACC_INIT`."""
    del head_query, head_target
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    nq, nt = _count(n_query, kq, dev), _count(n_target, kt, dev)
    q_live = torch.arange(kq, device=dev) < nq
    t_live = torch.arange(kt, device=dev) < nt
    dq = torch.full((kq,), ACC_INIT, dtype=torch.float32, device=dev)
    dt = torch.full((kt,), ACC_INIT, dtype=torch.float32, device=dev)
    step = _chunk(kq)
    for c0 in range(0, kt, step):
        d = _sq_dist(query, target[:, c0:c0 + step])
        d = torch.where(q_live[:, None] & t_live[None, c0:c0 + step], d, torch.inf)
        dq = torch.minimum(dq, d.amin(1))
        dt[c0:c0 + step] = torch.minimum(dt[c0:c0 + step], d.amin(0))
    return dq, dt


def nearest_sq_dual(query, target, n_query=None, n_target=None, head_query=None,
                    head_target=None):
    """``(per query, per target)`` least squared distances from one pass
    over the distance tiles: (Kq,), (Kt,) float32."""
    if query.device.type == "cpu":
        return nearest_sq_dual_plain(query, target, n_query, n_target, head_query, head_target)
    _check("nearest_sq_dual", query, target)
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    nq, nt = _count(n_query, kq, dev), _count(n_target, kt, dev)
    hq, ht = _count(head_query, 0, dev), _count(head_target, 0, dev)
    outq = torch.empty((kq,), dtype=torch.float32, device=dev)
    # the per-target minima are merged across query blocks by atomicMin
    outt = torch.full((kt,), ACC_INIT, dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind("edt", "nearest_sq_dual", [P, P, P, P, I, I, P, P, P, P, I, P])
    err = _build.call_on(
        dev, fn, query.data_ptr(), target.data_ptr(), outq.data_ptr(), outt.data_ptr(), kq, kt,
        nq.data_ptr(), nt.data_ptr(), hq.data_ptr(), ht.data_ptr(), TILE,
    )
    _build.check(err, "nearest_sq_dual")
    LAUNCHES["nearest_sq_dual"] += 1
    return outq, outt


# ---------------------------------------------------------------------------
# nearest_sq_pruned
# ---------------------------------------------------------------------------

def _blocks(pts: torch.Tensor) -> torch.Tensor:
    """(3, K) points padded with :data:`COORD_PAD` to whole blocks → (3, G, B)."""
    b = PRUNED_BLOCK
    k = pts.shape[1]
    g = -(-k // b)
    if g * b != k:
        pts = torch.nn.functional.pad(pts, (0, g * b - k), value=COORD_PAD)
    return pts.reshape(3, g, b)


def pruned_block_order(query, target, n_target) -> "tuple[torch.Tensor, torch.Tensor]":
    """Per query block, the target blocks in ascending order of the squared
    gap between their bounding boxes (a lower bound on every cross-block
    distance): ``(order (Gi, Gj) int32, dsort (Gi, Gj) float32)``.  Blocks
    entirely at or past ``n_target`` get the bound 3e38 and are never
    visited.  The sort is stable, so ties keep block order on every device."""
    big = 2.0 * COORD_PAD

    def boxes(pts):
        p = _blocks(pts)
        real = p[0:1] < COORD_PAD  # pads sit at exactly COORD_PAD
        return torch.where(real, p, big).amin(2), torch.where(real, p, -big).amax(2)

    qmn, qmx = boxes(query)
    tmn, tmx = boxes(target)
    gap = torch.clamp(torch.maximum(
        qmn[:, :, None] - tmx[:, None, :], tmn[:, None, :] - qmx[:, :, None]
    ), min=0.0)
    dmin = (gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]
    gj = tmn.shape[1]
    nt = _count(n_target, target.shape[1], query.device)
    dead = torch.arange(gj, device=query.device) * PRUNED_BLOCK >= nt
    dmin = torch.where(dead[None, :], 3.0e38, dmin)
    dsort, order = torch.sort(dmin, dim=1, stable=True)
    return order.to(torch.int32).contiguous(), dsort.contiguous()


def nearest_sq_pruned_plain(query, target, q_lo, q_hi, n_target, with_tiles: bool = False):
    """Plain PyTorch version of :func:`nearest_sq_pruned`: every query block
    walks its target blocks in the same order, all blocks in lockstep, with
    the same stopping rule, so it visits the same tiles as the kernel."""
    b = PRUNED_BLOCK
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    order, dsort = pruned_block_order(query, target, n_target)
    gi, gj = order.shape
    lo = _count(q_lo, 0, dev)
    hi = torch.clamp(_count(q_hi, kq, dev), max=kq)
    nt = torch.clamp(_count(n_target, kt, dev), max=kt)
    qb = _blocks(query)
    tb = _blocks(target)
    qn = (qb[0] * qb[0] + qb[1] * qb[1]) + qb[2] * qb[2]
    tn = (tb[0] * tb[0] + tb[1] * tb[1]) + tb[2] * tb[2]
    t_live = (torch.arange(gj * b, device=dev) < nt).reshape(gj, b)
    start = torch.arange(gi, device=dev) * b
    qidx = start[:, None] + torch.arange(b, device=dev)
    meaningful = (qidx >= lo) & (qidx < hi)
    active = (start < hi) & (start + b > lo)
    cur = torch.full((gi, b), ACC_INIT, dtype=torch.float32, device=dev)
    bound = torch.full((gi,), ACC_INIT, dtype=torch.float32, device=dev)
    tiles = torch.zeros((gi,), dtype=torch.int32, device=dev)
    qrows = qb.permute(1, 2, 0)  # (Gi, B, 3)
    for s in range(gj):
        active = active & (dsort[:, s] <= bound)
        if not bool(active.any()):
            break
        jj = order[:, s].long()
        cross = torch.bmm(qrows, tb[:, jj].permute(1, 0, 2))  # (Gi, B, B)
        d = (tn[jj][:, None, :] + qn[:, :, None]) - 2.0 * cross
        d = torch.where(t_live[jj][:, None, :], d, torch.inf)
        cur = torch.where(active[:, None], torch.minimum(cur, d.amin(2)), cur)
        best = torch.where(meaningful, cur, -1.0).amax(1)
        bound = torch.where(active, best, bound)
        tiles += active.to(torch.int32)
    out = cur.reshape(-1)[:kq]
    return (out, tiles) if with_tiles else out


def nearest_sq_pruned(query, target, q_lo, q_hi, n_target, with_tiles: bool = False):
    """Exact pruned search: per query point in ``[q_lo, q_hi)``, the least
    squared distance to the targets ``[0, n_target)``, walking the target
    blocks of each query block in :func:`pruned_block_order` and stopping at
    the first whose box bound exceeds the block's running max-of-mins.

    Returns (Kq,) float32, and with ``with_tiles`` also the (Gi,) int32
    number of target blocks each query block visited."""
    if query.device.type == "cpu":
        return nearest_sq_pruned_plain(query, target, q_lo, q_hi, n_target, with_tiles)
    _check("nearest_sq_pruned", query, target)
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    order, dsort = pruned_block_order(query, target, n_target)
    gi, gj = order.shape
    lo, hi = _count(q_lo, 0, dev), _count(q_hi, kq, dev)
    nt = _count(n_target, kt, dev)
    out = torch.empty((kq,), dtype=torch.float32, device=dev)
    tiles = torch.empty((gi,), dtype=torch.int32, device=dev)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind(
        "edt", "nearest_sq_pruned", [P, P, P, P, P, P, I, I, I, P, P, P, I, P]
    )
    err = _build.call_on(
        dev, fn, query.data_ptr(), target.data_ptr(), order.data_ptr(), dsort.data_ptr(),
        out.data_ptr(), tiles.data_ptr(), kq, kt, gj, lo.data_ptr(), hi.data_ptr(),
        nt.data_ptr(), PRUNED_BLOCK,
    )
    _build.check(err, "nearest_sq_pruned")
    LAUNCHES["nearest_sq_pruned"] += 1
    return (out, tiles) if with_tiles else out
