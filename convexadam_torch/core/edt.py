"""Surface point-set HD95 on the device, and a jump-flooding distance map.

Counterpart of ``convexadam_tpu/core/edt.py``.  The reference computes
HD95 with full-volume EDTs in a host loop over labels
(self_configuring/convexAdam_hyper_util.py:32-51).
The percentile only samples the distance map at surface voxels, and the
nearest opposite-class voxel of a mask f, seen from outside (inside), lies
on f's inner (outer) surface.  So the metric reduces to nearest-neighbour
searches between small integer point sets, carried by the three kernels of
:mod:`convexadam_torch.kernels.edt`, and is exact.

Reference semantics kept exactly:

* ``dist1 = edt(f) + edt(1 - f)``, the distance to the nearest voxel of the
  other class;
* ``surf = (edt(f) == 1)``, foreground voxels with a face-adjacent
  background voxel;
* ``hd95 = max(percentile(dist1[surf2], 95), percentile(dist2[surf1], 95))``
  with numpy's linear-interpolation percentile;
* a label missing from either volume scores ``missing_value`` (30).

What the JAX package needed only on the TPU is left out: the
``optimization_barrier`` fences, the ``lax.map``/``vmap`` label chunking
(``label_chunk``; here the pruned branch runs every search of a label
bucket in one batched call, and the percentiles of all its labels in one
sort), the ``CONVEXADAM_HD95_PALLAS`` switch to the XLA searches and the bfloat16
cross term (``coords_bf16_exact``).  On the card nothing routes the searches
to their plain versions; for CPU tensors the kernel wrappers run them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.features import label_counts
from convexadam_torch.kernels.edt import (
    COORD_PAD,
    host_ints,
    nearest_sq,
    nearest_sq_dual,
    nearest_sq_pruned_batched,
)
from convexadam_torch.utils import trace

#: Per-axis extent limit of the engine.  Label buffers move coordinates as one
#: packed int32 (z<<20 | y<<10 | x), 10 bits per axis, and the searches'
#: FP32 distances are exact only while coordinates stay below 1024: then
#: |q|^2 + |t|^2 <= 2 * 3 * 1023^2 < 2^24.  Wider packing alone would not lift
#: it.  The evaluator raises beyond it on the card and uses the host
#: :func:`convexadam_torch.core.metrics.hd95` only when asked for the CPU.
MAX_PACKED_EXTENT = 1024

_SENTINEL = 2**30  # "no seed known" squared distance
_REL_SENT = 8192  # sentinel relative offset: 3 * (8192 + 512)^2 < 2^31


def _jump_schedule(max_dim: int) -> "list[int]":
    """1+JFA+1: an extra 1-jump pass before and after the halving sequence
    starting at the next power of two >= max_dim / 2."""
    jumps = [1]
    j = 1
    while j * 2 < max_dim:
        j *= 2
    while j >= 1:
        jumps.append(j)
        j //= 2
    jumps.append(1)
    return jumps


def jump_flood_sqdist(seeds: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distance to the nearest True voxel of ``seeds``
    (..., H, W, D) bool, by jump flooding: (..., H, W, D) int32, ``2**30``
    where a batch slice has no seed at all; batch dims are flooded
    independently.  Library API (nothing in the package calls it), on the
    input's device.

    Each voxel carries the relative int16 offset of its best seed; shifting
    the state by a jump turns a neighbour's offset into a candidate by
    adding the jump vector, with shifts that wrap masked off.  The passes,
    the 26 directions and every comparison come in the JAX package's order,
    so the integers are its integers (jump flooding may miss the exact
    nearest seed; both packages miss the same ones)."""
    shape = seeds.shape
    H, W, D = shape[-3:]
    dev = seeds.device
    s = seeds.reshape((-1, H, W, D)).bool()
    rel = torch.where(s[:, None], 0, _REL_SENT).to(torch.int16).expand(-1, 3, -1, -1, -1).clone()
    d2 = torch.where(s, 0, _SENTINEL).to(torch.int32)
    iz = torch.arange(H, device=dev).reshape(H, 1, 1)
    iy = torch.arange(W, device=dev).reshape(1, W, 1)
    ix = torch.arange(D, device=dev).reshape(1, 1, D)
    dirs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)
            if (a, b, c) != (0, 0, 0)]
    for k in _jump_schedule(max(H, W, D)):
        for a, b, c in dirs:
            dz, dy, dx = a * k, b * k, c * k
            cand = torch.roll(rel, (-dz, -dy, -dx), dims=(2, 3, 4))
            cand = cand + torch.tensor([dz, dy, dx], dtype=torch.int16,
                                       device=dev).reshape(1, 3, 1, 1, 1)
            valid = (((iz + dz >= 0) & (iz + dz < H)) & ((iy + dy >= 0) & (iy + dy < W))
                     & ((ix + dx >= 0) & (ix + dx < D)))
            c32 = cand.to(torch.int32)
            cd2 = c32[:, 0] * c32[:, 0] + c32[:, 1] * c32[:, 1] + c32[:, 2] * c32[:, 2]
            # a neighbour that knows no seed carries the sentinel offset:
            # without this guard a seedless slice would return its square
            from_seed = c32.abs().amax(dim=1) < (_REL_SENT // 2)
            cd2 = torch.where(valid & from_seed, cd2, _SENTINEL)
            better = cd2 < d2
            d2 = torch.where(better, cd2, d2)
            rel = torch.where(better[:, None], cand, rel)
    return d2.reshape(shape)


def _compact(mask_flat: torch.Tensor, K: int):
    """First K True positions of a flat mask, in raster order: ((K,) int32
    indices padded with -1, the true count as a 0-dim tensor, which may
    exceed K).  A cumsum and a scatter: no wait for the host."""
    n = mask_flat.shape[0]
    dev = mask_flat.device
    pos = torch.cumsum(mask_flat.to(torch.int32), 0) - 1
    tgt = torch.where(mask_flat & (pos < K), pos, K)  # slot K is dropped
    buf = torch.full((K + 1,), -1, dtype=torch.int32, device=dev)
    buf.scatter_(0, tgt.long(), torch.arange(n, dtype=torch.int32, device=dev))
    count = (pos[-1] + 1).to(torch.int32) if n > 0 else torch.zeros((), dtype=torch.int32,
                                                                    device=dev)
    return buf[:K], count


#: Largest label-bucket K at which the pruned search runs, as measured on the
#: card (``scripts/time_kernels.py --threshold``)
PRUNED_SEARCH_MAX_K = 1 << 20


def _pruned_search_enabled(K: int) -> bool:
    """Whether :func:`hd95_from_buffers` takes the batched pruned search;
    otherwise the dual pass and two tiled searches run.

    The JAX package caps the pruned search at K * 12 <= 6 MB, its TPU
    kernel's whole target set in VMEM.  The Hopper kernel reads each visited
    tile from global memory and the order tables stay within
    ``PRUNED_TABLE_ENTRIES`` a launch, so that limit does not apply.  On an
    H100 (``scripts/time_kernels.py --threshold``: one organ against its
    copy rolled by a few voxels) the pruned search's kernels take a fraction
    of the dual + tiled searches' device time at every K from 16384 to
    1048576, and its whole call is the shorter one from K = 131072 up; below
    that, one label's call is the longer one by its fixed host cost, which
    the labels of a bucket share.  So it runs at every K that is a multiple
    of its tile up to :data:`PRUNED_SEARCH_MAX_K`.  A larger bucket is filled
    by a speckled prediction (a ball filling a 192^3 volume has about 10^5
    surface voxels), and on a speckled organ the dual + tiled call is the
    shorter one at every K from 65536 to 2097152: it does only the live
    pairs, while the pruned call builds order tables for the whole bucket.
    Both branches give the same HD95."""
    return K % 128 == 0 and K <= PRUNED_SEARCH_MAX_K


def _percentile_sorted(vals: torch.Tensor, n: torch.Tensor, q: float) -> torch.Tensor:
    """numpy's linear-interpolation percentile of the first ``n`` entries
    of ascending ``vals`` (the tail is +inf), per row of ``vals`` (..., K)
    with ``n`` of shape (...)."""
    rank = (q / 100.0) * (n.to(torch.float32) - 1.0)
    k = torch.clamp(torch.floor(rank).long(), min=0)
    frac = rank - k.to(torch.float32)
    k2 = torch.minimum(k + 1, torch.clamp(n.long() - 1, min=0))
    vk = vals.gather(-1, k[..., None])[..., 0]
    vk2 = vals.gather(-1, k2[..., None])[..., 0]
    return torch.where(n > 0, vk + frac * (vk2 - vk), 0.0)


class SurfaceLists(NamedTuple):
    """Compacted all-labels surface lists of a (fixed, moving) pair."""

    own_f: torch.Tensor      # (Kg,) int16 label at each fixed surface voxel (-1 pad)
    nbv_f: torch.Tensor      # (6, Kg) int16 face-neighbour labels (sentinel pad)
    gc_f: torch.Tensor       # (3, Kg) f32 coords (COORD_PAD pad)
    inside_f: torch.Tensor   # (Kg,) bool: the other volume has the same label
    own_m: torch.Tensor
    nbv_m: torch.Tensor
    gc_m: torch.Tensor
    inside_m: torch.Tensor
    counts_f: torch.Tensor   # (num_labels+1,) per-label voxel counts
    counts_m: torch.Tensor
    n_total_f: torch.Tensor  # true boundary-voxel count (may exceed Kg)
    n_total_m: torch.Tensor


class SurfaceSide(NamedTuple):
    """One volume's compacted surface list (half of :class:`SurfaceLists`)."""

    own: torch.Tensor      # (Kg,) int16 label at each surface voxel (-1 pad)
    nbv: torch.Tensor      # (6, Kg) int16 face-neighbour labels (sentinel pad)
    gc: torch.Tensor       # (3, Kg) f32 coords (COORD_PAD pad)
    inside: torch.Tensor   # (Kg,) bool (all False when built without seg_other)
    gidx: torch.Tensor     # (Kg,) int32 compacted flat indices (-1 pad)
    counts: torch.Tensor   # (num_labels+1,) per-label voxel counts
    n_total: torch.Tensor  # true boundary count (may exceed Kg)


def _neighbor_stack(seg: torch.Tensor) -> torch.Tensor:
    """(6, H, W, D) face-neighbour values, edge-replicated, so borders never
    count as surface against the outside (scipy's EDT measures within the
    array)."""
    outs = []
    for ax in range(3):
        n = seg.shape[ax]
        outs.append(torch.cat([seg.narrow(ax, 0, 1), seg.narrow(ax, 0, n - 1)], ax))
        outs.append(torch.cat([seg.narrow(ax, 1, n - 1), seg.narrow(ax, n - 1, 1)], ax))
    return torch.stack(outs)


def surface_side(
    seg: torch.Tensor,
    num_labels: int,
    global_surface: "int | None" = None,
    seg_other: "torch.Tensor | None" = None,
) -> SurfaceSide:
    """Surface list of one volume: every voxel with a differing face
    neighbour, compacted in raster order, with its own label, its six
    neighbour labels and its coordinates, and per-label voxel counts.

    When own + 6 neighbour labels fit one int32 (<= 14 labels) they are
    packed into one word per voxel and gathered once, as in the JAX package;
    the unpacked path gathers them separately (the neighbour sentinel is
    then -1 instead of the field's all-ones value).  With ``seg_other`` the
    agreement bit (the other volume has the same label there) rides along;
    without it ``inside`` is all False (see :func:`inside_flags`)."""
    H, W, D = seg.shape
    if max(H, W, D) > MAX_PACKED_EXTENT:
        raise ValueError(
            f"surface_side supports dims <= {MAX_PACKED_EXTENT} "
            f"(got {(H, W, D)}): label_buffers packs coordinates as "
            "10-bit fields"
        )
    N = H * W * D
    Kg = min(N, 262144) if global_surface is None else min(N, global_surface)
    sg = seg.to(torch.int16)
    bits = (num_labels + 1).bit_length()
    packed = 7 * bits <= 30  # one spare bit for the agreement flag
    fsent = (1 << bits) - 1
    eq = None
    if seg_other is not None:
        eq = (sg == seg_other.to(torch.int16)).reshape(-1)

    nb = _neighbor_stack(sg)
    diff = (nb != sg[None]).any(0).reshape(-1)
    gidx, n_total = _compact(diff, Kg)
    gvalid = gidx >= 0
    safe = torch.clamp(gidx, min=0).long()
    if packed:
        word = sg.to(torch.int32)
        for k in range(6):
            word = word | (nb[k].to(torch.int32) << (bits * (k + 1)))
        if eq is not None:
            word = word | (eq.reshape(sg.shape).to(torch.int32) << (7 * bits))
        w = torch.where(gvalid, word.reshape(-1)[safe], -1)
        fmask = (1 << bits) - 1
        own = torch.where(gvalid, w & fmask, -1).to(torch.int16)
        nbv = torch.stack([
            torch.where(gvalid, (w >> (bits * (k + 1))) & fmask, fsent).to(torch.int16)
            for k in range(6)
        ])
        inside = (
            gvalid & (((w >> (7 * bits)) & 1) == 1) if eq is not None
            else torch.zeros_like(gvalid)
        )
    else:
        own = torch.where(gvalid, sg.reshape(-1)[safe], -1)
        nbv = torch.where(gvalid[None], nb.reshape(6, -1)[:, safe], -1)
        inside = gvalid & eq[safe] if eq is not None else torch.zeros_like(gvalid)
    z = safe // (W * D)
    y = (safe // D) % W
    x = safe % D
    coords = torch.where(gvalid[None], torch.stack([z, y, x]).to(torch.float32), COORD_PAD)
    counts = label_counts(sg, num_labels + 1)
    return SurfaceSide(own, nbv, coords, inside, gidx, counts, n_total)


def inside_flags(side: SurfaceSide, seg_self: torch.Tensor, seg_other: torch.Tensor) -> torch.Tensor:
    """Agreement bits of a side built without ``seg_other``: a surface voxel
    of label l is inside the other volume's l-mask iff the volumes agree
    there."""
    eq = (seg_self.to(torch.int16) == seg_other.to(torch.int16)).reshape(-1)
    gvalid = side.gidx >= 0
    return gvalid & eq[torch.clamp(side.gidx, min=0).long()]


def surface_lists(
    seg_fixed: torch.Tensor,
    seg_moving: torch.Tensor,
    num_labels: int,
    global_surface: "int | None" = None,
) -> SurfaceLists:
    """Surface lists of a volume pair: one :func:`surface_side` per volume
    with the agreement bit of the other."""
    f = surface_side(seg_fixed, num_labels, global_surface, seg_moving)
    m = surface_side(seg_moving, num_labels, global_surface, seg_fixed)
    return SurfaceLists(
        f.own, f.nbv, f.gc, f.inside,
        m.own, m.nbv, m.gc, m.inside,
        f.counts, m.counts, f.n_total, m.n_total,
    )


class LabelBuffers(NamedTuple):
    """Per-label surface point buffers, concatenated along the point axis at
    the offsets of the ``label_caps`` prefix sums."""

    inner_f: torch.Tensor   # (3, M) z,y,x; [inside | outside] segments per label
    outer_f: torch.Tensor   # (3, M)
    inner_m: torch.Tensor
    outer_m: torch.Tensor
    n_inner_f: torch.Tensor  # (num_labels+1,) true inner-surface counts
    n_inner_m: torch.Tensor
    n_inside_f: torch.Tensor  # (num_labels+1,) inner voxels inside the other mask
    n_inside_m: torch.Tensor
    n_outer_f: torch.Tensor  # (num_labels+1,) true outer-shell counts
    n_outer_m: torch.Tensor
    counts_f: torch.Tensor   # (num_labels+1,) per-label voxel counts
    counts_m: torch.Tensor


def label_buffers(
    pre: SurfaceLists,
    num_labels: int,
    label_caps: "tuple[int, ...]",
) -> LabelBuffers:
    """Partition the surface lists into per-label buffers.

    ``label_caps``: (num_labels + 1,) per-label point capacities (entry 0,
    the background, must be 0).  A label's inner surface is ordered
    ``[inside the other mask | outside]``, raster order within each segment:
    inside queries only search the other volume's outer shell and outside
    queries its inner surface, and the segment boundary (``n_inside_*``) lets
    the searches skip dead blocks.  Its outer shell holds each neighbouring
    voxel once per distinct neighbour label.  On overflow the inside segment
    keeps its first ``cap`` voxels and the outside segment is cut."""
    inner_f, n_inner_f, n_inside_f = label_buffers_inner(
        pre.own_f, pre.gc_f, pre.inside_f, num_labels, label_caps
    )
    outer_f, n_outer_f = label_buffers_outer(pre.own_f, pre.nbv_f, pre.gc_f, num_labels, label_caps)
    inner_m, n_inner_m, n_inside_m = label_buffers_inner(
        pre.own_m, pre.gc_m, pre.inside_m, num_labels, label_caps
    )
    outer_m, n_outer_m = label_buffers_outer(pre.own_m, pre.nbv_m, pre.gc_m, num_labels, label_caps)
    return LabelBuffers(
        inner_f, outer_f, inner_m, outer_m,
        n_inner_f, n_inner_m, n_inside_f, n_inside_m,
        n_outer_f, n_outer_m, pre.counts_f, pre.counts_m,
    )


def _caps_offsets(label_caps):
    offs_host = []
    acc = 0
    for c in label_caps:
        offs_host.append(acc)
        acc += int(c)
    return offs_host, acc


def _pack_coords(gc: torch.Tensor) -> torch.Tensor:
    """(3, K) integer-valued f32 coords → (K,) packed int32.  Real coords lie
    in [0, MAX_PACKED_EXTENT) (:func:`surface_side` raises beyond it and
    :func:`caps_overflow` audits the range); pad rows clamp to 1023 and are
    only written through dropped scatter targets."""
    c = torch.clamp(gc.to(torch.int32), 0, 1023)
    return (c[0] << 20) | (c[1] << 10) | c[2]


def _unpack_coords(buf: torch.Tensor) -> torch.Tensor:
    """(M,) packed int32 (-1 = empty slot) → (3, M) f32, COORD_PAD pads."""
    coords = torch.stack([(buf >> 20) & 1023, (buf >> 10) & 1023, buf & 1023]).to(torch.float32)
    return torch.where(buf[None, :] < 0, COORD_PAD, coords)


def _label_tables(label_caps, device):
    offs_host, M = _caps_offsets(label_caps)
    caps = torch.tensor([int(c) for c in label_caps], dtype=torch.int32, device=device)
    offs = torch.tensor(offs_host, dtype=torch.int32, device=device)
    return caps, offs, M


def _scatter_packed(M: int, tgt: torch.Tensor, packed: torch.Tensor, out=None) -> torch.Tensor:
    """Write ``packed`` at ``tgt`` into an (M + 1,) buffer of -1 whose last
    slot takes (and drops) every target set to M."""
    if out is None:
        out = torch.full((M + 1,), -1, dtype=torch.int32, device=packed.device)
    return out.scatter_(0, tgt.long(), packed)


def label_buffers_inner(
    own: torch.Tensor,
    gc: torch.Tensor,
    inside: torch.Tensor,
    num_labels: int,
    label_caps: "tuple[int, ...]",
):
    """One side's inner buffers: the surface list partitioned by own label
    into [inside | outside] segments.  Returns (inner (3, M), n_inner,
    n_inside)."""
    dev = own.device
    caps, offs, M = _label_tables(label_caps, dev)
    labs = torch.arange(num_labels + 1, dtype=own.dtype, device=dev)
    onehot = own[None, :] == labs[:, None]  # (L+1, Kg)
    ranks_in = torch.cumsum((onehot & inside[None, :]).to(torch.int32), 1, dtype=torch.int32) - 1
    ranks_out = torch.cumsum((onehot & ~inside[None, :]).to(torch.int32), 1,
                             dtype=torch.int32) - 1
    n_inside = ranks_in[:, -1] + 1
    n_inner = n_inside + ranks_out[:, -1] + 1
    labelled = (own >= 1) & (own <= num_labels)
    lab = torch.where(labelled, own.long(), 0)
    pos_in = ranks_in.gather(0, lab[None])[0]
    pos_out = n_inside[lab] + ranks_out.gather(0, lab[None])[0]
    pos = torch.where(inside, pos_in, pos_out)
    valid = labelled & (pos < caps[lab])
    tgt = torch.where(valid, offs[lab] + pos, M)
    inner_w = _scatter_packed(M, tgt, _pack_coords(gc))
    return _unpack_coords(inner_w[:M]), n_inner, n_inside


def label_buffers_outer(
    own: torch.Tensor,
    nbv: torch.Tensor,
    gc: torch.Tensor,
    num_labels: int,
    label_caps: "tuple[int, ...]",
):
    """One side's outer buffers: the <= 6 neighbour labels of each surface
    voxel, deduplicated within the voxel, each adding the voxel to that
    label's outer shell.  Returns (outer (3, M), n_outer)."""
    dev = own.device
    caps, offs, M = _label_tables(label_caps, dev)
    labs = torch.arange(num_labels + 1, dtype=nbv.dtype, device=dev)
    packed = _pack_coords(gc)
    dedup = [torch.ones(own.shape, dtype=torch.bool, device=dev)]
    for k in range(1, 6):
        seen = nbv[k] == nbv[0]
        for kp in range(1, k):
            seen = seen | (nbv[k] == nbv[kp])
        dedup.append(~seen)
    ovalid = (
        (nbv != own[None])
        & (nbv >= 1)
        & (nbv <= num_labels)
        & torch.stack(dedup)
        & (own >= 0)[None]
    )  # (6, Kg)
    hit = torch.zeros((num_labels + 1, own.shape[0]), dtype=torch.bool, device=dev)
    for k in range(6):
        hit = hit | (ovalid[k][None, :] & (nbv[k][None, :] == labs[:, None]))
    oranks = torch.cumsum(hit.to(torch.int32), 1, dtype=torch.int32) - 1
    outer_w = None
    for k in range(6):
        lab = torch.where(ovalid[k], nbv[k].long(), 0)
        rank_k = oranks.gather(0, lab[None])[0]
        ok = ovalid[k] & (rank_k < caps[lab])
        otgt = torch.where(ok, offs[lab] + rank_k, M)
        outer_w = _scatter_packed(M, otgt, packed, outer_w)
    n_outer = oranks[:, -1] + 1
    return _unpack_coords(outer_w[:M]), n_outer


def caps_overflow(
    pre: SurfaceLists,
    bufs: LabelBuffers,
    label_caps: "tuple[int, ...]",
) -> torch.Tensor:
    """0-dim bool: True when any buffer truncated: a label's true inner or
    outer count exceeds its cap (every label but the background is audited,
    whatever its cap), a volume's true boundary count exceeds the global
    list, or a surface coordinate falls outside the packed range."""
    capv = torch.tensor([int(c) for c in label_caps], dtype=torch.int32, device=pre.gc_f.device)
    per_label = torch.maximum(
        torch.maximum(bufs.n_inner_f, bufs.n_inner_m),
        torch.maximum(bufs.n_outer_f, bufs.n_outer_m),
    )
    over_lab = torch.any(per_label[1:] > capv[1:])
    kg = pre.gc_f.shape[1]

    def coords_bad(gc):
        real = gc[0] != COORD_PAD
        return torch.any(real & torch.any((gc < 0) | (gc >= MAX_PACKED_EXTENT), dim=0))

    return (
        over_lab
        | (pre.n_total_f > kg) | (pre.n_total_m > kg)
        | coords_bad(pre.gc_f) | coords_bad(pre.gc_m)
    )


def pruned_searches(bufs: LabelBuffers, label_caps: "tuple[int, ...]", K: int,
                    labels: "tuple[int, ...]"):
    """The four pruned searches of each label of a bucket, as
    :func:`convexadam_torch.kernels.edt.nearest_sq_pruned_batched` takes
    them: ``(sources, searches, q_lo, q_hi, n_target)``, label-major, in
    the order (inner_m -> inner_f, inner_f -> inner_m, inner_m -> outer_f,
    inner_f -> outer_m).  The queries and targets are read in place at each
    label's offset of the buffers; the counts stay on the card.

    Each direction's queries are the other volume's inner surface: those
    inside this volume's mask (the head segment) search its outer shell,
    those outside (the tail) its inner surface."""
    offs = _caps_offsets(label_caps)[0]
    labs = host_ints(labels, bufs.inner_f.device).long()
    n_f, n_m = bufs.n_inner_f[labs], bufs.n_inner_m[labs]
    # segment boundaries clamp to the cap (overflow keeps inside first)
    in_f = torch.clamp(bufs.n_inside_f[labs], max=K)
    in_m = torch.clamp(bufs.n_inside_m[labs], max=K)
    zero = torch.zeros_like(in_f)
    q_lo = torch.stack([in_m, in_f, zero, zero], 1).reshape(-1)
    q_hi = torch.stack([torch.clamp(n_m, max=K), torch.clamp(n_f, max=K), in_m, in_f],
                       1).reshape(-1)
    n_target = torch.stack([n_f, n_m, bufs.n_outer_f[labs], bufs.n_outer_m[labs]], 1).reshape(-1)
    sources = (bufs.inner_f, bufs.inner_m, bufs.outer_f, bufs.outer_m)
    searches = []
    for lab in labels:
        o = offs[lab]
        searches += [(1, o, 0, o), (0, o, 1, o), (1, o, 2, o), (0, o, 3, o)]
    return sources, searches, q_lo, q_hi, n_target


def hd95_from_buffers(
    bufs: LabelBuffers,
    label_caps: "tuple[int, ...]",
    max_surface: int,
    missing_value: float = 30.0,
    labels: "tuple[int, ...]" = (),
) -> torch.Tensor:
    """Per-label HD95 of ``labels`` from :class:`LabelBuffers`, each of cap
    ``max_surface`` (the label buckets of :func:`suggest_hd95_caps`) →
    (len(labels),) float32.  The pruned branch runs every search of the
    bucket in one batched call; the dual + tiled branch runs three per
    label.  Both end in one sort over the (2 x labels, K) distances."""
    K = max_surface
    for lab in labels:
        if label_caps[lab] != K:
            raise ValueError(f"label {lab} has cap {label_caps[lab]} != bucket K {K}")
    dev = bufs.inner_f.device
    labs = host_ints(labels, dev).long()
    if _pruned_search_enabled(K):
        out = nearest_sq_pruned_batched(*pruned_searches(bufs, label_caps, K, labels), K, K)
        d_in_m, d_in_f, d_out_m, d_out_f = out.reshape(len(labels), 4, K).unbind(1)
    else:
        offs = _caps_offsets(label_caps)[0]
        parts = []
        for lab in labels:
            sl = slice(offs[lab], offs[lab] + K)
            ci_f = bufs.inner_f[:, sl].contiguous()
            ci_m = bufs.inner_m[:, sl].contiguous()
            in_f = torch.clamp(bufs.n_inside_f[lab], max=K)
            in_m = torch.clamp(bufs.n_inside_m[lab], max=K)
            # the shared inner x inner block: direction 1 takes its row
            # minima and direction 2 its column minima from one pass
            d_in = nearest_sq_dual(ci_m, ci_f, n_query=bufs.n_inner_m[lab],
                                   n_target=bufs.n_inner_f[lab], head_query=in_m, head_target=in_f)
            d_out_m = nearest_sq(ci_m, bufs.outer_f[:, sl].contiguous(), n_query=in_m,
                                 n_target=bufs.n_outer_f[lab])
            d_out_f = nearest_sq(ci_f, bufs.outer_m[:, sl].contiguous(), n_query=in_f,
                                 n_target=bufs.n_outer_m[lab])
            parts.append((*d_in, d_out_m, d_out_f))
        d_in_m, d_in_f, d_out_m, d_out_f = (torch.stack(p) for p in zip(*parts))
    # the p95 of the distance to the nearest opposite-class voxel over each
    # direction's query surface (the other volume's inner surface of the
    # label): rows [0, L) direction 1, [L, 2L) direction 2
    d_in = torch.cat([d_in_m, d_in_f])
    d_out = torch.cat([d_out_m, d_out_f])
    n_inside = torch.clamp(torch.cat([bufs.n_inside_m[labs], bufs.n_inside_f[labs]]), max=K)
    n_q = torch.cat([bufs.n_inner_m[labs], bufs.n_inner_f[labs]])
    iota = torch.arange(K, device=dev)
    d2 = torch.where(iota < n_inside[:, None], d_out, d_in)
    d = torch.where(iota < n_q[:, None], torch.sqrt(d2), torch.inf)
    # truncated surfaces: first-K bias
    p95 = _percentile_sorted(torch.sort(d, dim=1).values, torch.clamp(n_q, max=K), 95.0)
    hd = torch.maximum(p95[:len(labels)], p95[len(labels):])
    present = (bufs.counts_f[labs] > 0) & (bufs.counts_m[labs] > 0)
    return torch.where(present, hd, missing_value).to(torch.float32)


def surface_stats(seg, num_labels: int):
    """Host-side per-label surface sizing of one volume: ``(need, total)``
    with ``need[lab] = max(inner surface, outer shell)`` voxel counts (a
    1-voxel-thick structure's outer shell exceeds its inner surface) and
    ``total`` the all-labels boundary-voxel count."""
    seg = np.asarray(seg)
    nb = []
    for ax in range(3):
        for sh in (1, -1):
            r = np.roll(seg, sh, ax)
            sl = tuple(
                slice(0, 1) if (i == ax and sh == 1)
                else (slice(-1, None) if (i == ax and sh == -1) else slice(None))
                for i in range(3)
            )
            r[sl] = seg[sl]
            nb.append(r)
    nb = np.stack(nb)
    diff = (nb != seg[None]).any(0)
    idx = np.flatnonzero(diff.ravel())
    own = seg.ravel()[idx].astype(np.int64)
    nbl = nb.reshape(6, -1)[:, idx].astype(np.int64)
    inner = np.bincount(own[(own >= 1) & (own <= num_labels)], minlength=num_labels + 1)
    # outer shell: neighbour labels deduplicated within a voxel, own excluded
    keep = np.ones(nbl.shape, bool)
    for k in range(1, 6):
        for kp in range(k):
            keep[k] &= nbl[k] != nbl[kp]
    keep &= (nbl != own[None]) & (nbl >= 1) & (nbl <= num_labels)
    outer = np.bincount(nbl[keep], minlength=num_labels + 1)
    return np.maximum(inner, outer), int(idx.size)


def suggest_hd95_caps(
    seg_fixed,
    seg_moving,
    num_labels: int,
) -> "tuple[tuple[tuple[tuple[int, ...], int], ...], int]":
    """Exact buffer sizing from host segmentations: ``(groups, global_cap)``
    with ``groups`` a tuple of ``(labels, K)`` buckets, K covering every
    bucketed label's inner surface and outer shell in both volumes, and
    ``global_cap`` covering each volume's all-labels surface list.  Caps
    round up to powers of two times 4096, as in the JAX package, so that
    both packages bucket the labels identically."""
    need_f, tot_f = surface_stats(seg_fixed, num_labels)
    need_m, tot_m = surface_stats(seg_moving, num_labels)

    def round_pow2_4096(n: int) -> int:
        k = 4096
        while k < n:
            k *= 2
        return k

    need = np.maximum(need_f, need_m)
    n_vox = int(np.asarray(seg_fixed).size)
    cap_max = round_pow2_4096(n_vox)
    buckets: dict = {}
    for lab in range(1, num_labels + 1):
        k = min(round_pow2_4096(max(int(need[lab]), 1)), cap_max)
        buckets.setdefault(k, []).append(lab)
    groups = tuple((tuple(labs), k) for k, labs in sorted(buckets.items()))
    global_cap = min(round_pow2_4096(max(tot_f, tot_m, 1)), cap_max)
    return groups, global_cap


def _hd95_bucketed(seg_fixed, seg_moving, num_labels: int, groups, global_surface: int,
                   missing_value: float) -> torch.Tensor:
    caps_l = [0] * (num_labels + 1)
    for labs, k in groups:
        for lab in labs:
            caps_l[lab] = k
    caps = tuple(caps_l)
    with trace.span("hd95.surface_buffers"):
        pre = surface_lists(seg_fixed, seg_moving, num_labels, global_surface)
        bufs = label_buffers(pre, num_labels, caps)
    with trace.span("hd95.searches"):
        parts = [hd95_from_buffers(bufs, caps, k, missing_value, labs) for labs, k in groups]
    order = [lab for labs, _ in groups for lab in labs]
    inv = [0] * len(order)
    for i, lab in enumerate(order):
        inv[lab - 1] = i
    return torch.cat(parts)[torch.tensor(inv, device=seg_fixed.device)]


def _labels_on(seg, device) -> torch.Tensor:
    if isinstance(seg, torch.Tensor):
        return seg.to(device)
    return torch.from_numpy(np.ascontiguousarray(seg)).to(device)


def hd95_device_sized(
    seg_fixed,
    seg_moving,
    num_labels: int,
    missing_value: float = 30.0,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """:func:`hd95_device` with caps measured exactly from the two volumes
    (:func:`suggest_hd95_caps`, on the host) and per-size label buckets:
    nothing truncates, and small organs pay small searches.  Volumes are
    numpy arrays or tensors, moved to ``device`` (``cuda`` unless
    ``device="cpu"``); extents are limited to :data:`MAX_PACKED_EXTENT` per
    axis.  Returns (num_labels,) float32."""
    dev = _resolve_device(device)
    with trace.span("hd95.host_caps"):
        host_f = seg_fixed.cpu().numpy() if isinstance(seg_fixed, torch.Tensor) else seg_fixed
        host_m = seg_moving.cpu().numpy() if isinstance(seg_moving, torch.Tensor) else seg_moving
        groups, global_cap = suggest_hd95_caps(host_f, host_m, num_labels)
    return _hd95_bucketed(
        _labels_on(seg_fixed, dev), _labels_on(seg_moving, dev), num_labels, groups,
        global_cap, missing_value,
    )


def hd95_device(
    seg_fixed,
    seg_moving,
    num_labels: int,
    missing_value: float = 30.0,
    max_surface: "int | None" = None,
    global_surface: "int | None" = None,
    labels: "tuple[int, ...] | None" = None,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Per-label HD95 between integer label volumes (H, W, D) on the device,
    with the host :func:`convexadam_torch.core.metrics.hd95`'s semantics.

    Exact while no label surface exceeds ``max_surface`` points (default
    ``min(N, 65536)``) and all surfaces fit ``global_surface`` (default
    ``4 * max_surface``); an overflowing surface is cut to its first K
    points in raster order.  ``labels`` restricts the evaluation to a subset
    (default ``1 .. num_labels``).  Volumes run on ``device``, ``cuda``
    unless ``device="cpu"``.  Returns (len(labels),) float32."""
    dev = _resolve_device(device)
    seg_fixed = _labels_on(seg_fixed, dev)
    seg_moving = _labels_on(seg_moving, dev)
    H, W, D = seg_fixed.shape
    if max_surface is None:
        max_surface = min(H * W * D, 65536)
    if global_surface is None:
        global_surface = 4 * max_surface
    pre = surface_lists(seg_fixed, seg_moving, num_labels, global_surface)
    if labels is None:
        labels = tuple(range(1, num_labels + 1))
    caps = (0,) + (max_surface,) * num_labels
    bufs = label_buffers(pre, num_labels, caps)
    return hd95_from_buffers(bufs, caps, max_surface, missing_value, labels)
