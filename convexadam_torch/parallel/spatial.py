"""Spatial sharding: one registration's volumes split along H over the
ranks of a process group.

Counterpart of the JAX package's ``register_pairs_sharded(..., shard_space=
True)`` (``convexadam_tpu/parallel/batch.py``), where GSPMD splits each
volume along its first axis over the mesh's ``space`` axis and inserts the
halo exchanges itself.  Here every step of the MIND pipeline that reads
across a slab edge states its halo, takes it from the neighbours with
:func:`exchange_halo`, runs the one-volume function on the grown slab and
crops to the rows the rank owns.  At a global edge no rows are added, so the
function's own replicate or zero padding falls where it falls on the whole
volume, and each voxel's arithmetic is the one-volume run's:

* the slab plan (:func:`slab_plan`): slab edges on multiples of
  ``lcm(grid_sp, grid_sp_adam * adam_sample_stride)`` full-resolution rows,
  so the pooling to the coarse and Adam grids is local;
* MIND: ``r + d`` image rows; the variance's global mean is taken of the
  variance gathered whole (:func:`gather_rows`) on every rank, so it is the
  one-volume value to the bit (a sum reduced across ranks would not be);
* the cost volume: the fixed coarse slab grown by the box passes' reach, the
  moving one by ``disp_hw`` more, read at the kernel's moving row offset;
  each box pass of the coupling's picked field takes one row a side;
* the coarse fields are small: both directions are gathered, and inverse
  consistency runs on the whole fields on every rank;
* resizes are separable: along H with the global sizes on the rows a rank
  needs, then along W and D;
* the Adam stage: the pooled moving features are gathered once (the data
  term's gather has no bounded reach); each iteration the field is grown by
  ``2R + 1`` rows (``R`` the smoother's reach), the smoother, data term and
  regulariser run on the grown rows with the whole grid's counts, and only
  the owned rows' gradient is kept (exact: no adjoint reduce, which would add
  partial gradients in another order);
* the final upsample and box cascade: the Adam rows the resize reads and the
  cascade's reach.

So every rank's field equals the one-process field to the bit.  Halos go
point to point: with NCCL, ``batch_isend_irecv``; with gloo, ``isend`` and
``irecv`` on CPU tensors, a CUDA tensor staged through the host.  A failed
or stalled exchange raises (the process group's timeout).
"""

from __future__ import annotations

import dataclasses
import math
import torch
import torch.distributed as dist

from convexadam_torch.core import features
from convexadam_torch.core.adam import _adam_loop, _grad_step_fused, _sub_lattice
from convexadam_torch.core.adam import resolve_smoother, smoother_reach
from convexadam_torch.core.convex import box3, convex_displacement
from convexadam_torch.core.smoothing import avg_pool3d, box_smooth_repeated
from convexadam_torch.core.warp import inverse_consistency, resize_rows, resize_source_rows
from convexadam_torch.kernels.warp import sub_extent
from convexadam_torch.parallel.distributed import all_gather_tensor, world
from convexadam_torch.pipeline.convex_adam import check_grids

# bytes this process received by exchange_halo and gather_rows
TRAFFIC = {"halo_bytes": 0, "gather_bytes": 0}


@dataclasses.dataclass(frozen=True)
class SlabPlan:
    """Each rank's slab of a volume of ``size`` rows along H: rank ``c`` owns
    the full-resolution rows ``starts[c] .. starts[c + 1] - 1``; ``coord`` is
    this rank's.  At a grid pooled by ``f`` (a multiple of which every start
    is) the slab is ``starts[c] // f ..``, the last one to ``size // f``."""

    size: int
    starts: tuple
    coord: int

    def rows(self, f: int = 1) -> "list[tuple[int, int]]":
        n = len(self.starts) - 1
        return [(self.starts[c] // f, self.starts[c + 1] // f if c < n - 1 else self.size // f)
                for c in range(n)]

    def own(self, f: int = 1) -> "tuple[int, int]":
        return self.rows(f)[self.coord]


def slab_plan(size: int, unit: int, n_ranks: int, coord: int) -> SlabPlan:
    """Slabs of whole units of ``unit`` rows, as even as they come (the
    first ``units % n_ranks`` ranks take one more), the last also taking
    the rows past the last whole unit."""
    units = size // unit
    if units < n_ranks:
        raise ValueError(
            f"a volume of {size} rows along H holds {units} slabs of {unit} rows, fewer than the "
            f"{n_ranks} ranks of the space axis")
    base, extra = divmod(units, n_ranks)
    starts = tuple(unit * (c * base + min(c, extra)) for c in range(n_ranks)) + (size,)
    return SlabPlan(size, starts, coord)


def _axis_rows(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows ``a .. b - 1`` of ``x`` along H, its third axis from the end."""
    return x.narrow(x.ndim - 3, a, b - a)


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def exchange_halo(x: torch.Tensor, lo: int, hi: int, ranges, group=None):
    """This rank's slab ``x`` (..., rows, W, D) grown by up to ``lo`` rows
    before and ``hi`` after from the ranks that own them (``ranges``: every
    rank's (first, end) row, in rank order), nothing past a global edge.
    Every rank of ``group`` calls it with the same ``lo``, ``hi`` and
    ``ranges``; a halo may span several ranks.  Returns the grown slab and
    its first row."""
    n_ranks, me = world(group)
    if n_ranks == 1:
        return x, ranges[me][0]
    n = ranges[-1][1]

    def need(r):
        s, e = ranges[r]
        return ((max(0, s - lo), s), (e, min(n, e + hi)))

    def overlap(a, b):
        return max(a[0], b[0]), min(a[1], b[1])

    nccl = dist.get_backend(group) == "nccl"
    stage = x.is_cuda and not nccl  # gloo sends CPU tensors
    ops, recvs = [], {}
    for p in range(n_ranks):
        if p == me:
            continue
        for want in need(p):
            a, b = overlap(want, ranges[me])
            if a < b:
                buf = _axis_rows(x, a - ranges[me][0], b - ranges[me][0]).contiguous()
                ops.append((dist.isend, buf.cpu() if stage else buf, p))
        for want in need(me):
            a, b = overlap(want, ranges[p])
            if a < b:
                shape = list(x.shape)
                shape[-3] = b - a
                buf = torch.empty(shape, dtype=x.dtype, device="cpu" if stage else x.device)
                recvs[p] = buf
                ops.append((dist.irecv, buf, p))
    if nccl and ops:
        works = dist.batch_isend_irecv([dist.P2POp(op, buf, _peer(group, p), group)
                                        for op, buf, p in ops])
    else:
        works = [op(buf, _peer(group, p), group=group) for op, buf, p in ops]
    for w in works:
        w.wait()
    got = [recvs[p].to(x.device) for p in sorted(recvs)]
    TRAFFIC["halo_bytes"] += sum(t.numel() * t.element_size() for t in got)
    below = [t for p, t in zip(sorted(recvs), got) if p < me]
    above = [t for p, t in zip(sorted(recvs), got) if p > me]
    first = ranges[me][0] - sum(t.shape[-3] for t in below)
    return torch.cat(below + [x] + above, dim=x.ndim - 3) if got else x, first


def gather_rows(x: torch.Tensor, ranges, group=None) -> torch.Tensor:
    """Every rank's slab (..., rows, W, D) of ``group`` joined along H, on
    every rank: one all-gather of the slabs padded to the longest."""
    n_ranks, me = world(group)
    if n_ranks == 1:
        return x
    m = max(e - s for s, e in ranges)
    shape = list(x.shape)
    shape[-3] = m - x.shape[-3]
    padded = torch.cat([x, x.new_zeros(shape)], dim=x.ndim - 3)
    # two-byte types travel as bytes (gloo gathers no int16 or bfloat16), bit for bit
    wire = padded.view(torch.uint8) if padded.element_size() == 2 else padded
    parts = [p.view(x.dtype) for p in all_gather_tensor(wire, group)]
    TRAFFIC["gather_bytes"] += sum(p.numel() * p.element_size() for i, p in enumerate(parts)
                                   if i != me)
    return torch.cat([_axis_rows(p, 0, e - s) for p, (s, e) in zip(parts, ranges)],
                     dim=x.ndim - 3)


def uniform_halo(out_ranges, in_ranges, in_size: int, out_size: int) -> "tuple[int, int]":
    """The (lo, hi) input rows every rank must add to its own for a linear
    resize from ``in_size`` to ``out_size`` rows to make the output rows of
    ``out_ranges``: the most any rank needs, so that all exchange alike."""
    lo = hi = 0
    for (a, b), (s, e) in zip(out_ranges, in_ranges):
        if a < b:
            ia, ib = resize_source_rows(in_size, out_size, a, b)
            lo, hi = max(lo, s - ia), max(hi, ib - e)
    return lo, hi


def _mind_slab(img, cfg, plan, group, dtype):
    """MIND-SSC features (12, rows, W, D) of this rank's rows of a volume."""
    r, d = cfg.mind_r, cfg.mind_d
    x, first = exchange_halo(img, r + d, r + d, plan.rows(), group)
    mind, var = features.mind_ssd_stats(x.to(dtype).contiguous(), r, d)
    a, b = plan.own()
    mind, var = mind[:, a - first:b - first], var[a - first:b - first]
    gm = gather_rows(var, plan.rows(), group)[None].mean()
    return features.mind_epilogue(mind, var, gm, dtype)


def _convex_slab(fix_c, mov_c, cfg, plan, group):
    """One direction of the convex stage on coarse slabs: the cost volume of
    the grown slabs, the coupled convex field of the owned rows."""
    g, q, passes = cfg.grid_sp, cfg.disp_hw, cfg.cost_smooth_passes
    ranges = plan.rows(g)
    own0, own1 = plan.own(g)
    f, f0 = exchange_halo(fix_c, passes, passes, ranges, group)
    m, m0 = exchange_halo(mov_c, passes + q, passes + q, ranges, group)

    def smooth(field):
        e, e0 = exchange_halo(field, 1, 1, ranges, group)
        return box3(e)[:, own0 - e0:own1 - e0].contiguous()

    return convex_displacement(f, m, q, metric=cfg.cost_metric, smooth_passes=passes,
                               mov_row0=m0 - f0, rows=(own0 - f0, own1 - f0), smooth=smooth)


def _coarse_field(feat_fix, feat_mov, cfg, plan, group, record):
    """The convex stage's coarse field (3, h, w, d), whole on every rank, in
    full-resolution voxels: ``disp_ice * scale * g`` with inverse
    consistency, else ``disp_soft * g``."""
    g = cfg.grid_sp
    ranges = plan.rows(g)
    fix_c = avg_pool3d(feat_fix, g, stride=g)
    mov_c = avg_pool3d(feat_mov, g, stride=g)
    soft = gather_rows(_convex_slab(fix_c, mov_c, cfg, plan, group), ranges, group)
    if not cfg.ic:
        if record is not None:
            record["convex"] = (soft,)
        return soft * g
    soft_r = gather_rows(_convex_slab(mov_c, fix_c, cfg, plan, group), ranges, group)
    h, w, d = soft.shape[1:]
    scale = torch.tensor([(h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0], dtype=torch.float32,
                         device=soft.device).reshape(3, 1, 1, 1)
    ice, _ = inverse_consistency(soft / scale, soft_r / scale, iters=15)
    if record is not None:
        record["convex"] = (soft, soft_r)
        record["ic"] = ice
    return ice * scale * g


def _adam_slab(feat_fix, feat_mov, coarse, cfg, plan, group, shape, dtype):
    """The Adam stage on this rank's Adam-grid rows: the smoothed field of
    the last iteration (3, rows, w, d) in Adam-grid voxels."""
    H, W, D = shape
    g2, s = cfg.grid_sp_adam, cfg.adam_sample_stride
    grid = (H // g2, W // g2, D // g2)
    ranges = plan.rows(g2)
    a, b = plan.own(g2)
    patch_fix = avg_pool3d(feat_fix.float(), g2, stride=g2)
    patch_mov = gather_rows(avg_pool3d(feat_mov.float(), g2, stride=g2).to(dtype), ranges, group)
    if cfg.ic:
        # the one-volume path resizes to full resolution, then to the Adam grid
        fa, fb = resize_source_rows(H, grid[0], a, b)
        full = resize_rows(coarse, shape, (fa, fb))
        init = resize_rows(full, grid, (a, b), in_h=H, x_row0=fa)
    else:
        init = resize_rows(coarse, grid, (a, b))
    init = init / g2

    reach = smoother_reach(cfg.adam_smoother)
    halo = -(-(2 * reach + 1) // s) * s  # lattice-aligned: grown slabs start on the lattice
    fix_e, first = exchange_halo(patch_fix, halo, halo, ranges, group)
    C = fix_e.shape[0]
    fix_flat = _sub_lattice(fix_e, s).reshape(C, -1).contiguous()
    n_points = math.prod(sub_extent(n, s) for n in grid)
    gh, gw, gd = grid
    counts = (3 * (gh - 1) * gw * gd, 3 * gh * (gw - 1) * gd, 3 * gh * gw * (gd - 1))
    smooth_fn = resolve_smoother(cfg.adam_smoother)
    mov = patch_mov.contiguous()

    def grad_fn(w):
        # the owned rows' gradient of the grown field's loss: the whole
        # field's, with no partial gradients to add across ranks
        w_e, _ = exchange_halo(w.detach(), halo, halo, ranges, group)
        loss, ds, grad = _grad_step_fused(w_e.requires_grad_(True), fix_flat, mov,
                                          cfg.lambda_weight, smooth_fn, 12.0, s,
                                          (first // s, n_points, counts))
        return loss, ds[:, a - first:b - first], grad[:, a - first:b - first].contiguous()

    return _adam_loop(grad_fn, init, cfg.selected_niter)[0]


def register_slab(fix, mov, cfg, plan: SlabPlan, group=None, record=None) -> torch.Tensor:
    """The MIND pipeline (:func:`~convexadam_torch.pipeline.convex_adam.convex_adam_torch`)
    of one pair split along H: ``fix`` and ``mov`` (rows, W, D) are this
    rank's rows of ``plan`` (float32, on its device), ``group`` the ranks
    that hold the others.  Returns the whole field (H, W, D, 3) in voxels on
    every rank, equal to the one-process field to the bit.  ``record``, a
    dict, receives the whole intermediate results: ``features``, ``convex``
    (one or both directions), ``ic``, ``adam`` (Adam-grid voxels)."""
    H = plan.size
    W, D = fix.shape[1:]
    shape = (H, W, D)
    g2 = cfg.grid_sp_adam
    run_adam = cfg.lambda_weight > 0
    check_grids(cfg, shape, adam=run_adam)
    dtype = cfg.compute_dtype(fix.device)
    ranges = plan.rows()
    with torch.no_grad():
        feat_fix, feat_mov = (_mind_slab(x, cfg, plan, group, dtype) for x in (fix, mov))
        if record is not None:
            record["features"] = tuple(gather_rows(f, ranges, group) for f in (feat_fix, feat_mov))
        coarse = _coarse_field(feat_fix, feat_mov, cfg, plan, group, record)
    a, b = plan.own()
    if not run_adam:
        field = resize_rows(coarse, shape, (a, b))
    else:
        fitted = _adam_slab(feat_fix, feat_mov, coarse, cfg, plan, group, shape, dtype)
        if record is not None:
            record["adam"] = gather_rows(fitted, plan.rows(g2), group)
        k = cfg.selected_smooth
        k += k > 0 and k % 2 == 0  # an even cascade is rounded up, as the one-volume path does
        reach = 3 * (k // 2)
        out_ranges = [(max(0, s - reach), min(H, e + reach)) for s, e in ranges]
        lo, hi = uniform_halo(out_ranges, plan.rows(g2), H // g2, H)
        x, first = exchange_halo(fitted, lo, hi, plan.rows(g2), group)
        ea, eb = out_ranges[plan.coord]
        field = resize_rows(x * g2, shape, (ea, eb), in_h=H // g2, x_row0=first)
        if k > 0:
            field = box_smooth_repeated(field, k, 3)
        field = field[:, a - ea:b - ea]
    return gather_rows(field.detach(), ranges, group).permute(1, 2, 3, 0)


def slab_unit(cfg) -> int:
    """Full-resolution rows a slab edge must fall on a multiple of: the
    coarse grid's, and the Adam grid's lattice."""
    if cfg.lambda_weight > 0:
        return math.lcm(cfg.grid_sp, cfg.grid_sp_adam * cfg.adam_sample_stride)
    return cfg.grid_sp
