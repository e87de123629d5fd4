"""Nearest-neighbour searches of the HD95 engine: wrappers of ``csrc/edt.cu``
and their plain versions.

* :func:`nearest_sq` replaces
  ``convexadam_tpu/ops/edt_pallas.py:nearest_sq_pallas``;
* :func:`nearest_sq_dual` replaces ``nearest_sq_dual_pallas``;
* :func:`nearest_sq_pruned` and :func:`nearest_sq_pruned_batched` (many
  searches in one launch) replace ``nearest_sq_pruned_pallas``.

Points are (3, K) float32 rows of integer coordinates below 1024 in array
order; buffer tails hold :data:`COORD_PAD`.  The squared distance of two
real points is an integer below 2^24 and every product and partial sum on
the way is too, so it is exact in float32 in any order of operations: the
kernels and the plain versions agree bit for bit at every meaningful entry.

Meaningful entries (outside them the values are not meaningful, as in the
JAX package, and callers mask them):

* :func:`nearest_sq`: queries ``[0, n_query)``, each the least squared
  distance to the targets ``[0, n_target)`` (:data:`ACC_INIT` when there
  are none); the queries past ``n_query`` hold :data:`ACC_INIT` too;
* :func:`nearest_sq_dual`: the same per query in ``[head_query, n_query)``
  and per target in ``[head_target, n_target)`` (the min over queries
  ``[0, n_query)``); the (head_query x head_target) corner is dead;
* :func:`nearest_sq_pruned`: queries ``[q_lo, q_hi)``; in
  :func:`nearest_sq_pruned_batched`, each search's queries
  ``[q_lo[s], q_hi[s])``.

The counts may be Python ints or integer tensors (the engine passes them
on the card, so nothing waits for the host).  The pruned search's block
boxes and their ascending order (:func:`pruned_block_order`) are plain
PyTorch, shared by the wrapper and the plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from convexadam_torch.kernels import LAUNCHES, _build

COORD_PAD = 8192.0  # padded points: distance² ≥ (8192 - 1024)², never wins
ACC_INIT = 4.0 * COORD_PAD * COORD_PAD  # above any distance involving a pad
#: queries per CTA and targets per tile of the tiled and the dual kernel
SEARCH_TILE = 128
#: targets a CTA of the tiled and the dual kernel stages at once (the grid's second axis)
SEARCH_CHUNK = 1024
#: queries per block of the pruned search (one warp; each block keeps its own bound)
PRUNED_BLOCK = 32
#: targets per tile of the pruned search
PRUNED_TILE = 128
#: tiles a pruned block evaluates per step (one per warp) before it updates its bound
PRUNED_STEP = 4
#: order-table entries (query blocks x target tiles) of one pruned launch: 32 MB of tables
PRUNED_TABLE_ENTRIES = 1 << 22


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
    points (3, Kt) ``[0, n_target)`` → (Kq,) float32; queries at or past
    ``n_query`` hold :data:`ACC_INIT`."""
    if query.device.type == "cpu":
        return nearest_sq_plain(query, target, n_query, n_target)
    _check("nearest_sq", query, target)
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    nq, nt = _count(n_query, kq, dev), _count(n_target, kt, dev)
    # the minima are merged across target chunks by atomicMin; queries at or
    # past n_query keep the init
    out = torch.full((kq,), ACC_INIT, dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind("edt", "nearest_sq", [P, P, P, I, I, P, P, I, I, P])
    err = _build.call_on(
        dev, fn, query.data_ptr(), target.data_ptr(), out.data_ptr(), kq, kt, nq.data_ptr(),
        nt.data_ptr(), SEARCH_TILE, SEARCH_CHUNK,
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
    # both minima are merged across CTAs by atomicMin: per query across
    # target chunks, per target across query blocks
    outq = torch.full((kq,), ACC_INIT, dtype=torch.float32, device=dev)
    outt = torch.full((kt,), ACC_INIT, dtype=torch.float32, device=dev)
    P, I = _build.P, _build.I  # noqa: E741
    fn = _build.bind("edt", "nearest_sq_dual", [P, P, P, P, I, I, P, P, P, P, I, I, P])
    err = _build.call_on(
        dev, fn, query.data_ptr(), target.data_ptr(), outq.data_ptr(), outt.data_ptr(), kq, kt,
        nq.data_ptr(), nt.data_ptr(), hq.data_ptr(), ht.data_ptr(), SEARCH_TILE, SEARCH_CHUNK,
    )
    _build.check(err, "nearest_sq_dual")
    LAUNCHES["nearest_sq_dual"] += 1
    return outq, outt


# ---------------------------------------------------------------------------
# nearest_sq_pruned
# ---------------------------------------------------------------------------

def _pad_to(pts: torch.Tensor, b: int) -> torch.Tensor:
    """(3, K) points padded with :data:`COORD_PAD` to a multiple of ``b``
    (the tensor itself when K already is one)."""
    k = pts.shape[1]
    pad = -k % b
    return torch.nn.functional.pad(pts, (0, pad), value=COORD_PAD) if pad else pts


def _block_boxes(pts: torch.Tensor, b: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Bounding boxes of the real points of each block of ``b`` of (3, M)
    points, M a multiple of ``b``: (min, max), each (3, M / b).  An all-pad
    block gets an empty box far from every point."""
    big = 2.0 * COORD_PAD
    p = pts.reshape(3, -1, b)
    real = p[0:1] < COORD_PAD  # pads sit at exactly COORD_PAD
    return torch.where(real, p, big).amin(2), torch.where(real, p, -big).amax(2)


def _counts(v, n: int, default: int, device: torch.device) -> torch.Tensor:
    """Per-search counts as an (n,) int32 tensor on ``device``: a tensor
    of n (or one) elements, a sequence of ints, an int or None."""
    if v is None:
        v = default
    if not isinstance(v, torch.Tensor):
        v = torch.tensor(v, dtype=torch.int32)
    return v.reshape(-1).to(device=device, dtype=torch.int32).expand(n)


def host_ints(values, device: torch.device) -> torch.Tensor:
    """Host ints as an int32 tensor on ``device``, copied from pinned
    memory without waiting for the card (a plain ``torch.tensor(...,
    device=...)`` waits for every launch queued before it)."""
    t = torch.tensor(values, dtype=torch.int32, pin_memory=device.type == "cuda")
    return t.to(device, non_blocking=True)


class _PrunedPlan(NamedTuple):
    """The searches of one batched call cut into row parts of ``rows``
    queries (``parts`` a search) and the parts into launches."""

    table: torch.Tensor   # (S * parts, 7) int32: q_src, q_off, t_src, t_off, q_lo, q_hi, n_target
    starts: torch.Tensor  # (S * parts, 2) int32: the first query and target in ``points``
    points: torch.Tensor  # (3, sum M) the sources end to end
    boxes: tuple          # query-block (min, max) and target-tile (min, max) boxes of ``points``
    rows: int
    parts: int
    kt: int
    launches: list        # (first part, end part) of each launch


def _pruned_split(n_searches: int, kq: int, kt: int):
    """How a batched pruned call of ``n_searches`` searches of ``kq``
    queries over ``kt`` targets is cut: ``(parts, rows, launches)``, each
    search's rows in ``parts`` parts of ``rows`` (the order table of one
    part holds at most :data:`PRUNED_TABLE_ENTRIES`), and the ``[a, e)``
    ranges of the ``n_searches * parts`` parts that each launch takes (at
    most that many entries, and 65535 parts, a launch)."""
    gj, nb = kt // PRUNED_TILE, kq // PRUNED_BLOCK
    parts = next((c for c in range(1, nb + 1)
                  if nb % c == 0 and (nb // c) * gj <= PRUNED_TABLE_ENTRIES), nb)
    rows = kq // parts
    per = max(1, min(65535, PRUNED_TABLE_ENTRIES // ((rows // PRUNED_BLOCK) * gj)))
    n = n_searches * parts
    return parts, rows, [(a, min(a + per, n)) for a in range(0, n, per)]


def pruned_launch_count(n_searches: int, kq: int, kt: int) -> int:
    """Kernel launches of one :func:`nearest_sq_pruned_batched` call of
    ``n_searches`` searches on the card: one, unless their order tables
    outgrow :data:`PRUNED_TABLE_ENTRIES` (at ``kq = kt = 36864`` a launch
    takes 12 searches)."""
    return len(_pruned_split(n_searches, kq, kt)[2])


def _pruned_plan(sources, searches, q_lo, q_hi, n_target, kq: int, kt: int) -> _PrunedPlan:
    b, tile = PRUNED_BLOCK, PRUNED_TILE
    if not 1 <= len(sources) <= 4:
        raise ValueError(f"nearest_sq_pruned: 1 to 4 source buffers, got {len(sources)}")
    if kq % tile or kt % tile or kq <= 0 or kt <= 0:
        raise ValueError(f"nearest_sq_pruned: kq {kq} and kt {kt} must be positive multiples "
                         f"of {tile}")
    base = [0]
    for s in sources:
        if s.shape[1] % tile:
            raise ValueError(f"nearest_sq_pruned: source length {s.shape[1]} is not a multiple "
                             f"of {tile}")
        base.append(base[-1] + s.shape[1])
    for qs, qo, ts, to in searches:
        if qo % tile or to % tile or qo + kq > sources[qs].shape[1] or to + kt > sources[ts].shape[1]:
            raise ValueError(f"nearest_sq_pruned: search {(qs, qo, ts, to)} does not lie on "
                             f"{tile}-aligned blocks of its sources")
    dev = sources[0].device
    S = len(searches)
    parts, rows, launches = _pruned_split(S, kq, kt)
    lo = _counts(q_lo, S, 0, dev)
    hi = torch.clamp(_counts(q_hi, S, kq, dev), max=kq)
    nt = torch.clamp(_counts(n_target, S, kt, dev), max=kt)
    shift = torch.arange(parts, dtype=torch.int32, device=dev) * rows
    # per part: its buffers and offsets, and where they start in ``points``
    static = host_ints([(qs, qo + p * rows, ts, to, base[qs] + qo + p * rows, base[ts] + to)
                        for qs, qo, ts, to in searches for p in range(parts)], dev).reshape(-1, 6)
    table = torch.cat([
        static[:, :4],
        torch.stack([(lo[:, None] - shift).reshape(-1), (hi[:, None] - shift).reshape(-1),
                     nt.repeat_interleave(parts)], 1),
    ], 1).contiguous()
    # every tile boundary of ``points`` is one of its own source too
    points = torch.cat(sources, 1) if len(sources) > 1 else sources[0]
    return _PrunedPlan(table, static[:, 4:], points,
                       (*_block_boxes(points, b), *_block_boxes(points, tile)),
                       rows, parts, kt, launches)


def _pruned_order(plan: _PrunedPlan, a: int, e: int) -> "tuple[torch.Tensor, torch.Tensor]":
    """Block order of parts ``[a, e)``: per query block, the target tiles in
    ascending order of the squared gap between their bounding boxes (a lower
    bound on every cross-block distance), one stable sort for all of them:
    ``(order (P, Gi, Gj) int32, dsort (P, Gi, Gj) float32)``.  Tiles
    entirely at or past the search's ``n_target`` get the bound 3e38 and are
    never visited; ties keep tile order on every device."""
    b, tile = PRUNED_BLOCK, PRUNED_TILE
    dev = plan.table.device
    gi, gj = plan.rows // b, plan.kt // tile
    qmn, qmx, tmn, tmx = plan.boxes
    qi = plan.starts[a:e, 0:1] // b + torch.arange(gi, device=dev)  # (P, Gi)
    tj = plan.starts[a:e, 1:2] // tile + torch.arange(gj, device=dev)  # (P, Gj)
    qmn, qmx, tmn, tmx = qmn[:, qi], qmx[:, qi], tmn[:, tj], tmx[:, tj]
    gap = torch.clamp(torch.maximum(
        qmn[..., None] - tmx[:, :, None, :], tmn[:, :, None, :] - qmx[..., None]
    ), min=0.0)
    dmin = (gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]
    dead = torch.arange(gj, device=dev) * tile >= plan.table[a:e, 6:7]
    dmin = torch.where(dead[:, None, :], 3.0e38, dmin)
    dsort, order = torch.sort(dmin, dim=2, stable=True)
    return order.to(torch.int32), dsort


def _pruned_walk_plain(plan: _PrunedPlan, a: int, e: int, order, dsort):
    """Plain walk of parts ``[a, e)``: every query block of every part in
    lockstep, :data:`PRUNED_STEP` tiles a step, with the kernel's stopping
    rule, so it visits the same tiles.  Returns ((P, rows) minima, (P, Gi)
    visited tiles)."""
    b, tile, G = PRUNED_BLOCK, PRUNED_TILE, PRUNED_STEP
    dev = order.device
    P, gi, gj = order.shape
    B = P * gi
    table, starts, pts = plan.table[a:e], plan.starts[a:e].long(), plan.points
    q = pts[:, starts[:, 0:1] + torch.arange(plan.rows, device=dev)]  # (3, P, rows)
    q = q.reshape(3, B, b).permute(1, 2, 0)  # (B, b, 3)
    qn = (q[..., 0] * q[..., 0] + q[..., 1] * q[..., 1]) + q[..., 2] * q[..., 2]
    tstart = starts[:, 1].repeat_interleave(gi)
    lo, hi, nt = table[:, 4:5], table[:, 5:6], table[:, 6]
    start = torch.arange(gi, device=dev) * b
    qidx = (start[:, None] + torch.arange(b, device=dev)).reshape(1, -1)
    meaningful = ((qidx >= lo) & (qidx < hi)).reshape(B, b)
    active = (torch.maximum(start, lo) < torch.minimum(start + b, hi)).reshape(B)
    nt_b = nt.repeat_interleave(gi)
    order = order.reshape(B, gj).long()
    dsort = dsort.reshape(B, gj)
    cur = torch.full((B, b), ACC_INIT, dtype=torch.float32, device=dev)
    bound = torch.full((B,), ACC_INIT, dtype=torch.float32, device=dev)
    tiles = torch.zeros((B,), dtype=torch.int32, device=dev)
    lane = torch.arange(tile, device=dev)
    for j0 in range(0, gj, G):
        idx = active.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        w = min(G, gj - j0)
        inc = dsort[idx, j0:j0 + w] <= bound[idx, None]  # a prefix: dsort ascends
        loc = order[idx, j0:j0 + w, None] * tile + lane  # (n, w, tile) in the search
        t = pts[:, tstart[idx, None, None] + loc].reshape(3, -1, w * tile).permute(1, 0, 2)
        tn = (t[:, 0] * t[:, 0] + t[:, 1] * t[:, 1]) + t[:, 2] * t[:, 2]
        d = (tn[:, None, :] + qn[idx][:, :, None]) - 2.0 * torch.bmm(q[idx], t)
        live = inc[:, :, None] & (loc < nt_b[idx, None, None])
        d = torch.where(live.reshape(-1, 1, w * tile), d, torch.inf)
        cur[idx] = torch.minimum(cur[idx], d.amin(2))
        tiles[idx] += inc.sum(1, dtype=torch.int32)
        bound[idx] = torch.where(meaningful[idx], cur[idx], -1.0).amax(1)
        active[idx] = inc.all(1) & (w == G and j0 + G < gj)
    return cur.reshape(P, plan.rows), tiles.reshape(P, gi)


def _pruned_run(sources, searches, q_lo, q_hi, n_target, kq, kt, plain: bool):
    plan = _pruned_plan(sources, searches, q_lo, q_hi, n_target, kq, kt)
    dev = sources[0].device
    n = plan.table.shape[0]
    out = torch.empty((n, plan.rows), dtype=torch.float32, device=dev)
    tiles = torch.empty((n, plan.rows // PRUNED_BLOCK), dtype=torch.int32, device=dev)
    if not plain:
        P, I = _build.P, _build.I  # noqa: E741
        fn = _build.bind("edt", "nearest_sq_pruned", [P] * 4 + [I] * 4 + [P] * 5 + [I] * 6 + [P])
        src = [s.data_ptr() for s in sources] + [sources[0].data_ptr()] * (4 - len(sources))
        lds = [s.shape[1] for s in sources] + [0] * (4 - len(sources))
    for a, e in plan.launches:
        order, dsort = _pruned_order(plan, a, e)
        if plain:
            out[a:e], tiles[a:e] = _pruned_walk_plain(plan, a, e, order, dsort)
            continue
        table = plan.table[a:e]
        err = _build.call_on(
            dev, fn, *src, *lds, table.data_ptr(), order.data_ptr(), dsort.data_ptr(),
            out[a:e].data_ptr(), tiles[a:e].data_ptr(), e - a, plan.rows, kt, kt // PRUNED_TILE,
            PRUNED_BLOCK, PRUNED_TILE,
        )
        _build.check(err, "nearest_sq_pruned")
        LAUNCHES["nearest_sq_pruned"] += 1
    S = len(searches)
    return out.reshape(S, kq), tiles.reshape(S, kq // PRUNED_BLOCK)


def nearest_sq_pruned_batched_plain(sources, searches, q_lo, q_hi, n_target, kq: int, kt: int,
                                    with_tiles: bool = False):
    """Plain PyTorch version of :func:`nearest_sq_pruned_batched`, on any
    device: the same parts, block order and walk."""
    out, tiles = _pruned_run(sources, searches, q_lo, q_hi, n_target, kq, kt, plain=True)
    return (out, tiles) if with_tiles else out


def nearest_sq_pruned_batched(sources, searches, q_lo, q_hi, n_target, kq: int, kt: int,
                              with_tiles: bool = False):
    """S exact pruned searches in one pass, read in place from up to four
    (3, M) point buffers (``sources``).  Search s, ``searches[s] = (q_src,
    q_off, t_src, t_off)`` (host ints), takes the queries
    ``sources[q_src][:, q_off:q_off + kq]`` and the targets
    ``sources[t_src][:, t_off:t_off + kt]``; per query in ``[q_lo[s],
    q_hi[s])`` it gives the least squared distance to the targets
    ``[0, n_target[s])``.  Counts are (S,) integer tensors (on the card,
    nothing waits for the host), sequences of ints or ints.  ``kq``, ``kt``,
    the offsets and every source length are multiples of
    :data:`PRUNED_TILE`.

    Each query block of :data:`PRUNED_BLOCK` walks its target tiles in the
    ascending order of their box bounds, :data:`PRUNED_STEP` tiles a step,
    and stops after the first step that holds a tile whose bound exceeds
    the block's running max-of-mins over meaningful queries (that tile and
    every later one are not visited).  One launch covers every search while
    the order tables stay within :data:`PRUNED_TABLE_ENTRIES` entries; a
    larger batch, or a search larger than that alone, is cut into row parts
    and launches.

    Returns (S, kq) float32, and with ``with_tiles`` also the (S, kq /
    PRUNED_BLOCK) int32 tiles each query block visited."""
    plain = sources[0].device.type == "cpu"
    if not plain:
        _check("nearest_sq_pruned", *sources)
    out, tiles = _pruned_run(sources, searches, q_lo, q_hi, n_target, kq, kt, plain)
    return (out, tiles) if with_tiles else out


def _single(query, target, q_lo, q_hi, n_target):
    """One search as a batch of one, on copies padded to whole tiles where
    a count is ragged."""
    dev = query.device
    kq, kt = query.shape[1], target.shape[1]
    q, t = _pad_to(query, PRUNED_TILE), _pad_to(target, PRUNED_TILE)
    hi = torch.clamp(_count(q_hi, kq, dev), max=kq)
    nt = torch.clamp(_count(n_target, kt, dev), max=kt)
    return ([q, t], [(0, 0, 1, 0)], _count(q_lo, 0, dev), hi, nt, q.shape[1], t.shape[1])


def _single_result(res, kq: int, with_tiles: bool):
    out, tiles = res
    out, tiles = out[0, :kq], tiles[0, :-(-kq // PRUNED_BLOCK)]
    return (out, tiles) if with_tiles else out


def pruned_block_order(query, target, n_target) -> "tuple[torch.Tensor, torch.Tensor]":
    """The block order of one search (see :func:`_pruned_order`):
    ``(order (Gi, Gj) int32, dsort (Gi, Gj) float32)`` over the query
    blocks of :data:`PRUNED_BLOCK` and target tiles of :data:`PRUNED_TILE`
    of the points padded to whole tiles."""
    plan = _pruned_plan(*_single(query, target, 0, None, n_target))
    parts = [_pruned_order(plan, a, e) for a, e in plan.launches]
    gj = plan.kt // PRUNED_TILE
    return (torch.cat([o.reshape(-1, gj) for o, _ in parts]),
            torch.cat([d.reshape(-1, gj) for _, d in parts]))


def nearest_sq_pruned_plain(query, target, q_lo, q_hi, n_target, with_tiles: bool = False):
    """Plain PyTorch version of :func:`nearest_sq_pruned`: the batched plain
    version with one search."""
    res = nearest_sq_pruned_batched_plain(*_single(query, target, q_lo, q_hi, n_target),
                                          with_tiles=True)
    return _single_result(res, query.shape[1], with_tiles)


def nearest_sq_pruned(query, target, q_lo, q_hi, n_target, with_tiles: bool = False):
    """Exact pruned search of one query set (3, Kq) against one target set
    (3, Kt): per query point in ``[q_lo, q_hi)``, the least squared
    distance to the targets ``[0, n_target)``; the one-search case of
    :func:`nearest_sq_pruned_batched`.

    Returns (Kq,) float32, and with ``with_tiles`` also the (ceil(Kq /
    PRUNED_BLOCK),) int32 number of target tiles each query block
    visited."""
    if query.device.type != "cpu":
        _check("nearest_sq_pruned", query, target)
    res = nearest_sq_pruned_batched(*_single(query, target, q_lo, q_hi, n_target),
                                    with_tiles=True)
    return _single_result(res, query.shape[1], with_tiles)
