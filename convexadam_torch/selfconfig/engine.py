"""The semantic sweep engine: stage 1 (convex settings) and stage 2 (Adam
settings x 16 evaluation variants), scored by rank aggregation.

Counterpart of ``convexadam_tpu/selfconfig/engine.py``.  Reference
workloads (SURVEY.md §3.4): stage 1 sweeps 100 convex settings x N case
pairs (convex_run_withconfig.py), stage 2 sweeps 75 Adam settings x N pairs
x 16 evaluation variants (adam_run_withconfig_shiftSpline.py), each as a
sequential Python loop.  Here too settings and pairs are host loops, one
(setting, pair) at a time on a card.

With a ``mesh`` (a (setting, pair) grid of ranks from
``parallel.batch.make_sweep_mesh``) the sweep fans out over the ranks of a
process group, the counterpart of the reference's process-per-GPU sweeps
(convex_run_withconfig.py:42-43) and of the JAX package's mesh: the
settings still to run go in batches of ``setting_batch`` (by default one per
rank along ``setting``), each batch spread in contiguous blocks along the
``setting`` axis and the pairs along the ``pair`` axis.  After each batch
every rank gathers every (setting, pair)'s metrics on the host, so every rank
computes the same aggregates and returns the same ``SweepResult``; only rank
0 writes the checkpoint, once a batch.  Without a mesh, ``setting_batch``
sets how many settings run between two checkpoints.  The JAX package's
``pair_chunk`` splits one long XLA program, and a host loop over pairs has
no program to split; its compile-ahead workers hide remote compiles.  The
CUDA kernels are built once, before the first timed setting.

HD95 runs on the device engine (``core/edt.py``) on the card and in the
host scipy EDT loop on the CPU (``hd95_mode``).  The device scorer prepares
each pair's fixed side once per sweep and reads each case's buffers with
caps sized from the ground truth; a case whose warped surface outgrows them
is re-scored exactly right after its pair, outside the timed window.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from convexadam_torch import _resolve_device
from convexadam_torch.core.adam import adam_instance_optimisation
from convexadam_torch.core.edt import (
    MAX_PACKED_EXTENT,
    LabelBuffers,
    SurfaceLists,
    caps_overflow,
    hd95_device_sized,
    hd95_from_buffers,
    inside_flags,
    label_buffers_inner,
    label_buffers_outer,
    surface_side,
    surface_stats,
)
from convexadam_torch.core.features import label_counts, mindssc, semantic_features
from convexadam_torch.core.metrics import (
    dice_coeff,
    hd95,
    jacobian_determinant,
    rank_product,
    sort_rank,
)
from convexadam_torch.core.smoothing import avg_pool3d, box_smooth_repeated
from convexadam_torch.core.warp import resize_trilinear, warp_with_displacement
from convexadam_torch.kernels import _build
from convexadam_torch.kernels.edt import PRUNED_TILE, host_ints
from convexadam_torch.parallel.batch import Mesh, shard_range
from convexadam_torch.parallel.distributed import all_gather_object
from convexadam_torch.pipeline.convex_adam import (
    ConvexAdamConfig,
    _adam_inputs,
    _convex_pooled,
    _convex_stage,
    _upsample_and_smooth,
    check_grids,
)
from convexadam_torch.selfconfig.checkpoint import SweepCheckpointer
from convexadam_torch.selfconfig.l2r import _on, _sync
from convexadam_torch.selfconfig.settings import (
    STAGE2_SMOOTH_LEVELS,
    STAGE2_SNAPSHOT_ITERS,
    Stage1Setting,
    Stage2Setting,
)
from convexadam_torch.utils import trace

# ---------------------------------------------------------------------------
# per-pair computations
# ---------------------------------------------------------------------------


def convex_field_semantic(
    pred_fixed,
    pred_moving,
    nn_mult: float,
    num_labels: int,
    grid_sp: int,
    disp_hw: int,
    coarse: bool = False,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Convex stage on semantic features with inverse consistency
    (convex_run_withconfig.py:101-131) → the displacement (3, H, W, D) in
    fine-voxel units, or on the coarse grid (``coarse=True``, the stage-2
    cache, adam_run_withconfig_shiftSpline.py:126).  ``num_labels`` is the
    one-hot channel count.  Label volumes are numpy arrays or tensors, moved
    to ``device`` (``cuda`` unless ``device="cpu"``).  The features are made
    with ``mult=1`` and then scaled by ``nn_mult``, in the JAX package's
    order (in place), and pooled one at a time: the full-resolution ones
    (0.88 GB at 192 x 160 x 256 with 14 channels) are gone before the cost
    volume."""
    dev = _resolve_device(device)
    pf, pm = _on(pred_fixed, dev), _on(pred_moving, dev)
    cfg = ConvexAdamConfig(grid_sp=grid_sp, disp_hw=disp_hw, ic=True)
    check_grids(cfg, tuple(pf.shape))
    with torch.no_grad():
        with trace.span("convex.features"):
            ff, fm = semantic_features(pf, pm, num_labels=num_labels, mult=1.0)
            ff.mul_(nn_mult)
        with trace.span("convex.pool"):
            fix_s = avg_pool3d(ff, grid_sp, stride=grid_sp)
        del ff
        with trace.span("convex.features"):
            fm.mul_(nn_mult)
        with trace.span("convex.pool"):
            mov_s = avg_pool3d(fm, grid_sp, stride=grid_sp)
        del fm
        return _convex_pooled(fix_s, mov_s, cfg, tuple(pf.shape), coarse=coarse)


def convex_field_mind(
    img_fixed,
    img_moving,
    mind_r: int,
    mind_d: int,
    grid_sp: int,
    disp_hw: int,
    device: "str | torch.device | None" = None,
) -> torch.Tensor:
    """Convex stage on float32 MIND features (convex_run_paired_mind.py:101-165)
    → the displacement (3, H, W, D) in voxels; runs on ``device``."""
    dev = _resolve_device(device)
    f, m = _on(img_fixed, dev, torch.float32), _on(img_moving, dev, torch.float32)
    cfg = ConvexAdamConfig(grid_sp=grid_sp, disp_hw=disp_hw, ic=True)
    with torch.no_grad():
        with trace.span("convex.features"):
            ff, fm = mindssc(f, mind_r, mind_d), mindssc(m, mind_r, mind_d)
        return _convex_stage(ff, fm, cfg, tuple(f.shape))


def evaluate_field_semantic(
    disp_hr,
    seg_fixed,
    seg_moving,
    num_labels: int,
    device: "str | torch.device | None" = None,
):
    """Warp the moving segmentation (nearest) by ``disp_hr`` (3, H, W, D) and
    compute Dice, SDlogJ and the negative-Jacobian fraction
    (convex_run_withconfig.py:138-152).  Returns (dice (L,), sdlogj,
    neg_frac, seg_warped int16), tensors on ``device``; SDlogJ is the
    population standard deviation in float32, as in the JAX package."""
    dev = _resolve_device(device)
    d = _on(disp_hr, dev, torch.float32)
    with torch.no_grad():
        seg_w = warp_with_displacement(
            _on(seg_moving, dev, torch.float32)[None], d, mode="nearest"
        )[0].round().to(torch.int16)
        dice = dice_coeff(_on(seg_fixed, dev), seg_w, num_labels + 1)
        det = jacobian_determinant(d)
        logd = torch.log(torch.clamp(det + 3.0, 1e-9, 1e9))
        return dice, torch.std(logd, correction=0), (det < 0).float().mean(), seg_w


# ---------------------------------------------------------------------------
# HD95 over a sweep
# ---------------------------------------------------------------------------

#: largest per-label buffer of the sweep's HD95 buckets
SWEEP_MAX_CAP = 262144


def _suggest_label_groups(segs_np: np.ndarray, num_labels: int) -> "tuple[list, int]":
    """Bucket labels by surface size: ``([(labels, K)], global_cap)``.

    Each label's buffer K is 1.5x its largest ground-truth need,
    ``max(inner surface, outer shell)`` (``core/edt.py:surface_stats``),
    rounded up to a multiple of 4096 and at most 262144, as in the JAX
    package, so both packages bucket the labels alike.  The JAX package
    clamps K to the voxel count; the batched pruned search needs whole
    128-point tiles, so here the clamp is the voxel count rounded up to a
    multiple of 128 (slots past the voxel count stay empty padding, which
    no search reads as a point)."""
    per_label = np.ones(num_labels)
    total_worst = 1
    for seg in segs_np:
        need, total = surface_stats(seg, num_labels)
        total_worst = max(total_worst, total)
        per_label = np.maximum(per_label, need[1: num_labels + 1])
    n = int(np.prod(segs_np.shape[1:]))
    clamp = min(SWEEP_MAX_CAP, -(-n // PRUNED_TILE) * PRUNED_TILE)
    buckets: dict = {}
    for lab in range(1, num_labels + 1):
        k = 4096 * int(np.ceil(1.5 * per_label[lab - 1] / 4096))
        buckets.setdefault(min(max(k, 4096), clamp), []).append(lab)
    kg = 4096 * int(np.ceil(max(1.5 * total_worst, 4096) / 4096))
    return [(tuple(labs), k) for k, labs in sorted(buckets.items())], int(min(kg, n))


class _HD95Scorer:
    """Per-case HD95 on the device engine, the counterpart of the JAX
    package's ``_make_hd95_batch_fn``: the fixed side (surface list and
    outer shell) is prepared once per pair and sweep by :meth:`prep`; each
    case then builds the warped side and the inner buffers and runs
    :func:`hd95_from_buffers` once per label bucket (one batched pruned
    launch).  ``__call__`` returns the per-label HD95 (L,) float32 in label
    order and the cap-overflow flag, both on the card."""

    def __init__(self, num_labels: int, label_groups, global_surface: int,
                 device: torch.device):
        self.num_labels = num_labels
        self.groups = list(label_groups)
        self.global_surface = global_surface
        caps = [0] * (num_labels + 1)
        for labs, k in self.groups:
            for lab in labs:
                caps[lab] = k
        self.caps = tuple(caps)
        order = [lab for labs, _ in self.groups for lab in labs]
        # bucket order → label order, on the card without waiting for it
        self.inv = host_ints([order.index(lab) for lab in range(1, num_labels + 1)],
                             device).long()

    def prep(self, seg_fixed: torch.Tensor):
        side = surface_side(seg_fixed, self.num_labels, self.global_surface)
        outer, n_outer = label_buffers_outer(
            side.own, side.nbv, side.gc, self.num_labels, self.caps
        )
        return side, outer, n_outer

    def buffers(self, seg_fixed: torch.Tensor, prepared, seg_warped: torch.Tensor):
        """The case's :class:`SurfaceLists` and :class:`LabelBuffers`."""
        L, caps = self.num_labels, self.caps
        side_f, outer_f, n_outer_f = prepared
        side_m = surface_side(seg_warped, L, self.global_surface, seg_other=seg_fixed)
        in_f = inside_flags(side_f, seg_fixed, seg_warped)
        inner_f, n_inner_f, n_inside_f = label_buffers_inner(side_f.own, side_f.gc, in_f, L, caps)
        inner_m, n_inner_m, n_inside_m = label_buffers_inner(
            side_m.own, side_m.gc, side_m.inside, L, caps
        )
        outer_m, n_outer_m = label_buffers_outer(side_m.own, side_m.nbv, side_m.gc, L, caps)
        bufs = LabelBuffers(
            inner_f, outer_f, inner_m, outer_m,
            n_inner_f, n_inner_m, n_inside_f, n_inside_m,
            n_outer_f, n_outer_m, side_f.counts, side_m.counts,
        )
        pre = SurfaceLists(
            side_f.own, side_f.nbv, side_f.gc, in_f,
            side_m.own, side_m.nbv, side_m.gc, side_m.inside,
            side_f.counts, side_m.counts, side_f.n_total, side_m.n_total,
        )
        return pre, bufs

    def __call__(self, seg_fixed: torch.Tensor, prepared, seg_warped: torch.Tensor):
        with trace.span("hd95.surface_buffers"):
            pre, bufs = self.buffers(seg_fixed, prepared, seg_warped)
        with trace.span("hd95.searches"):
            parts = [hd95_from_buffers(bufs, self.caps, k, labels=labs) for labs, k in self.groups]
            per_label = torch.cat(parts)[self.inv]
        with trace.span("hd95.overflow"):
            return per_label, caps_overflow(pre, bufs, self.caps)


def _exact_hd95_rescore(
    seg_fixed_np: np.ndarray, seg_warped: torch.Tensor, num_labels: int
) -> float:
    """Exact per-case label-mean HD95 of a cap-overflow case: buffers
    measured from the two volumes (:func:`hd95_device_sized`) on the card,
    the host EDT loop on the CPU."""
    if seg_warped.device.type == "cuda":
        per_label = hd95_device_sized(
            seg_fixed_np, seg_warped.to(torch.int32), num_labels, device=seg_warped.device
        ).cpu().numpy()
    else:
        per_label = hd95(seg_fixed_np, seg_warped.numpy().astype(np.int32), num_labels)
    return float(np.mean(per_label.astype(np.float64)))


def _rescore_overflows(
    hd_case: np.ndarray,
    overflow: np.ndarray,
    seg_warped: "list[torch.Tensor]",
    seg_fixed_np: np.ndarray,
    num_labels: int,
) -> "tuple[int, float]":
    """Re-score in place every flagged case of one pair (``hd_case`` and
    ``overflow`` (V,), ``seg_warped`` the pair's V warped segmentations).
    Returns ``(n_rescored, seconds)``: the caller keeps the seconds out of
    the timed window and reports both in its result."""
    idxs = np.flatnonzero(overflow)
    if idxs.size == 0:
        return 0, 0.0
    warnings.warn(
        f"HD95 cap overflow on {idxs.size} sweep case(s): warped surfaces "
        "outgrew the GT-sized buffers; re-scoring those cases exactly",
        RuntimeWarning,
        stacklevel=3,
    )
    t0 = time.perf_counter()
    for v in idxs:
        hd_case[v] = _exact_hd95_rescore(seg_fixed_np, seg_warped[v], num_labels)
    return int(idxs.size), time.perf_counter() - t0


def _resolve_hd95_mode(hd95_mode, shape, device: torch.device) -> str:
    """``None`` is the device engine on the card and the host scipy EDT
    loop on the CPU.  The device engine needs every axis within
    :data:`MAX_PACKED_EXTENT`; beyond it this raises unless the caller asked
    for ``"host"``, so card tensors go to the host only when asked."""
    if hd95_mode is None:
        hd95_mode = "device" if device.type == "cuda" else "host"
    if hd95_mode not in ("device", "host"):
        raise ValueError(f"hd95_mode must be 'device', 'host' or None, got {hd95_mode!r}")
    if hd95_mode == "device" and max(shape) > MAX_PACKED_EXTENT:
        raise ValueError(
            f"device HD95 supports extents <= {MAX_PACKED_EXTENT} per axis (got "
            f"{tuple(shape)}); pass hd95_mode='host' or compute_hd95=False"
        )
    return hd95_mode


def _load_kernels(dev: torch.device) -> None:
    """Build (at first use) and load every kernel library before the first
    timed setting, so that no ``times[s]`` holds an ``nvcc`` build."""
    if dev.type == "cuda":
        with trace.span("sweep.prep.kernels"):
            _build.build_all()
            for name in _build.KERNEL_SOURCES:
                _build.load(name)


def _setting_sync(dev: torch.device) -> None:
    """Wait for the card before a setting's clock starts (a wait that
    torch's sync debug mode does not mark, so counted here)."""
    if dev.type == "cuda":
        _sync(dev)
        trace.count("host_waits.setting_sync")


def _recorded(sweep):
    """Run ``sweep`` inside a :func:`trace.recording` and return its
    ``SweepResult`` with the record's spans and counters (empty unless a
    profiler recorded)."""
    @functools.wraps(sweep)
    def run(*args, **kwargs):
        with trace.recording() as rec:
            res = sweep(*args, **kwargs)
        return dataclasses.replace(res, spans=rec.spans, counters=rec.counters)
    return run


class _Scoring:
    """What a sweep needs to score a field of pair ``i``: the label volumes
    on the device, the HD95 mode and, for the device engine, the scorer and
    the prepared fixed side of each pair in ``own`` (every pair by default;
    made once per sweep)."""

    def __init__(self, preds_np, segs_np, pairs, num_labels, compute_hd95, hd95_mode, dev,
                 own=None):
        self.dev, self.num_labels = dev, num_labels
        self.segs_np = segs_np
        self.fi = [p[0] for p in pairs]
        self.mi = [p[1] for p in pairs]
        with trace.span("sweep.prep.upload"):
            self.preds = torch.from_numpy(preds_np).to(dev)
            self.segs = torch.from_numpy(segs_np).to(dev)
        self.mode = (
            _resolve_hd95_mode(hd95_mode, segs_np.shape[1:], dev) if compute_hd95 else None
        )
        self.rescored, self.rescore_sec = 0, 0.0  # the sweep's cap-overflow audit
        self.scorer = self.sides = None
        if self.mode == "device":
            with trace.span("sweep.prep.label_groups"):
                groups, kg = _suggest_label_groups(segs_np, num_labels)
            own = range(len(self.fi)) if own is None else own
            with trace.span("sweep.prep.hd95_sides"), torch.no_grad():
                self.scorer = _HD95Scorer(num_labels, groups, kg, dev)
                self.sides = {i: self.scorer.prep(self.segs[self.fi[i]]) for i in own}

    def pair(self, s: int, i: int, fields):
        """Score the fields (3, H, W, D) of setting ``s`` and pair ``i``.
        Returns host arrays (dice (V, L) f32, sdlogj (V,) f32, neg_frac (V,)
        f32, hd95 (V,) f64) and the seconds to keep out of the timed window
        (the host HD95 loop, or the re-scoring, which also goes to the
        overflow audit)."""
        f, m, L = self.fi[i], self.mi[i], self.num_labels
        sf, sm = self.segs[f], self.segs[m]
        dice, js, nf, hd_l, over, warped = [], [], [], [], [], []
        with torch.no_grad():
            for disp in fields:
                with trace.span("sweep.evaluate", (s, i)):
                    d, j, n, sw = evaluate_field_semantic(disp, sf, sm, L, device=self.dev)
                dice.append(d), js.append(j), nf.append(n), warped.append(sw)
                if self.mode == "device":
                    with trace.span("sweep.hd95", (s, i)):
                        h, o = self.scorer(sf, self.sides[i], sw)
                    hd_l.append(h), over.append(o)
            # the pair's scalars to the host, after its last launch
            with trace.span("sweep.fetch", (s, i)):
                out = [torch.stack(x).cpu().numpy() for x in (dice, js, nf)]
                hd_case = np.full(len(warped), np.nan)  # no HD95 without compute_hd95
                if self.mode == "device":
                    hd_case = torch.stack(hd_l).cpu().numpy().astype(np.float64).mean(1)
                    over_np = torch.stack(over).cpu().numpy()
        t0 = time.perf_counter()
        if self.mode == "device":
            with trace.span("sweep.rescore", (s, i)):
                n_r, t_r = _rescore_overflows(hd_case, over_np, warped, self.segs_np[f], L)
            self.rescored += n_r
            self.rescore_sec += t_r
        elif self.mode == "host":
            for v, sw in enumerate(warped):
                hd_case[v] = hd95(self.segs_np[f], sw.cpu().numpy().astype(np.int32), L).mean()
        return (*out, hd_case), time.perf_counter() - t0


# ---------------------------------------------------------------------------
# stage 1
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    dice: np.ndarray  # (S, 2) mean / robust30 (paired sweeps: TRE mean / robust30)
    jstd: np.ndarray  # (S, 2) SDlogJ / negative fraction
    hd95: np.ndarray  # (S,)
    times: np.ndarray  # (S,) seconds per setting (all pairs)
    rank: np.ndarray  # (S,) or (S*V,) aggregated rank
    best: int
    # HD95 cap-overflow audit: cases re-scored exactly (outside the timed
    # window, which `times` excludes) and the seconds they took
    rescored: int = 0
    rescore_sec: float = 0.0
    # per-(setting, pair) metrics of the settings computed in this run (NaN
    # for settings restored from a checkpoint): "dice" (S, P[, 4, 4], L),
    # "sdlogj", "neg_jac_frac" and "hd95" (S, P[, 4, 4]); semantic sweeps only
    cases: dict = dataclasses.field(default_factory=dict)
    # settings restored from a checkpoint rather than run (0 when none was
    # given, or when it held another shape and was ignored)
    resumed: int = 0
    # this rank's record of the call (``utils/trace.py``): its spans and
    # counters, empty unless a profiler recorded
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


def _robust30_label_sets(
    segs: np.ndarray, pairs: Sequence[tuple], num_labels: int
) -> "list[np.ndarray]":
    """Per-pair sets of the 30% worst-Dice labels before registration
    (convex_run_withconfig.py:59-62; the reference's ``config['num_labels']``
    is our ``num_labels + 1``)."""
    out = []
    k = max(1, int((num_labels + 1) * 0.3))
    for (i, j) in pairs:
        d = dice_coeff(
            torch.from_numpy(np.asarray(segs[i])), torch.from_numpy(np.asarray(segs[j])),
            num_labels + 1,
        ).numpy()
        out.append(np.argsort(d)[:k])
    return out


def _restore(checkpoint_path, resume: bool, arrays: dict):
    """The checkpointer (or None) and the completed settings, with
    ``arrays`` (dice, jstd, hd95, times) filled in place from a matching
    checkpoint when resuming."""
    ck = SweepCheckpointer(checkpoint_path) if checkpoint_path is not None else None
    completed: set = set()
    if ck is not None and resume:
        st = ck.restore()
        if st is not None and "completed" in st and st["dice"].shape == arrays["dice"].shape:
            for k, a in arrays.items():
                a[:] = st[k]
            completed = {int(i) for i in st["completed"]}
    return ck, completed


def _save(ck, arrays: dict, completed: set) -> None:
    if ck is not None:
        ck.save(dict(arrays, completed=np.array(sorted(completed), np.int64)))


class _Fanout:
    """Which (setting, pair) cells this rank computes, and the gathers that
    give every rank all of them.  Without a mesh: every cell, no gather.

    ``batches`` cuts the settings to run into batches of ``setting_batch``
    (by default one per rank along ``setting``); :meth:`settings` is this
    rank's contiguous block of a batch along ``setting``, :attr:`pairs` its
    block of the pairs along ``pair``."""

    def __init__(self, mesh: "Mesh | None", n_pairs: int, setting_batch: "int | None"):
        self.mesh = mesh
        self.n_set = 1 if mesh is None else mesh.size("setting")
        self.set_coord = 0 if mesh is None else mesh.coord("setting")
        self.pairs = list(range(n_pairs)) if mesh is None else list(
            shard_range(n_pairs, mesh.size("pair"), mesh.coord("pair")))
        self.batch = max(1, self.n_set) if setting_batch is None else int(setting_batch)
        if self.batch < 1:
            raise ValueError(f"setting_batch must be at least 1, got {setting_batch}")
        # rank 0 writes the checkpoint and prints
        self.lead = mesh is None or mesh.rank == 0

    def batches(self, todo):
        return [todo[a:a + self.batch] for a in range(0, len(todo), self.batch)]

    def settings(self, batch):
        return [batch[j] for j in shard_range(len(batch), self.n_set, self.set_coord)]

    def gather(self, obj) -> list:
        """``obj`` of every rank, in rank order (``[obj]`` without a process
        group)."""
        if self.mesh is None or not self.mesh.distributed:
            return [obj]
        return all_gather_object(obj)


def _sweep_device(device, mesh: "Mesh | None") -> torch.device:
    """The sweep's device: ``device`` if given, else the mesh's, else
    ``cuda``."""
    if device is None and mesh is not None:
        return mesh.device
    return _resolve_device(device)


def _fill(cases: dict, times: np.ndarray, gathered: list, keys) -> None:
    """Every rank's cells ``(s, i, *values)`` into ``cases`` and, per
    setting, the longest any rank spent on it into ``times``."""
    secs: dict = {}
    for cells, rank_secs in gathered:
        for s, i, *vals in cells:
            for key, v in zip(keys, vals):
                cases[key][s, i] = v
        for s, t in rank_secs.items():
            secs[s] = max(secs.get(s, 0.0), t)
    for s, t in secs.items():
        times[s] = t


@_recorded
def run_stage1_sweep(
    preds: np.ndarray,
    segs: np.ndarray,
    pairs: Sequence[tuple],
    settings: Sequence[Stage1Setting],
    num_labels: int,
    compute_hd95: bool = True,
    verbose: bool = False,
    checkpoint_path=None,
    mesh: "Mesh | None" = None,
    setting_batch: "int | None" = None,
    resume: bool = False,
    hd95_mode: "str | None" = None,
    device: "str | torch.device | None" = None,
) -> SweepResult:
    """Stage-1 semantic sweep (convex_run_withconfig.py:78-172): for each
    setting and pair, the convex field on the one-hot predictions, then
    Dice and robust-30 Dice against the ground truth, SDlogJ, the
    negative-Jacobian fraction and HD95; settings are rank-aggregated over
    {Dice, robust30 Dice, HD95, SDlogJ} (HD95 only when computed).

    ``preds``/``segs``: (K, H, W, D) integer label volumes (predictions and
    ground truth); ``pairs``: (fixed_idx, moving_idx) tuples.  Runs on
    ``cuda`` unless ``device="cpu"`` (with a ``mesh``, on the mesh's
    device).  ``hd95_mode``: "device" (the surface point-set engine),
    "host" (the reference-style scipy EDT loop), or None: "device" on the
    card, "host" on the CPU.

    With ``checkpoint_path`` the metric arrays are saved after every batch
    of ``setting_batch`` settings; with ``resume`` completed settings are
    skipped, and a sweep with none left prepares nothing (no HD95 sides, no
    kernel build; stage 2 no pass A) and only ranks the restored arrays.
    With a ``mesh`` the (setting, pair) cells spread over the
    ranks (module docstring); ``dice``, ``jstd``, ``hd95``, ``rank`` and
    ``best`` equal the single-process run's to the bit on every rank.
    ``times[s]`` is the setting's seconds over its pairs, read after the
    card has finished, the host HD95 loop and overflow re-scoring left out;
    with a mesh, the longest any rank spent on it.
    """
    dev = _sweep_device(device, mesh)
    trace.on_device(dev)
    pairs = list(pairs)
    P, L = len(pairs), num_labels
    fan = _Fanout(mesh, P, setting_batch)
    S = len(settings)
    arrays = dict(dice=np.zeros((S, 2)), jstd=np.zeros((S, 2)), hd95=np.zeros(S),
                  times=np.zeros(S))
    dice, jstd, hd, times = arrays["dice"], arrays["jstd"], arrays["hd95"], arrays["times"]
    ck, completed = _restore(checkpoint_path, resume, arrays)
    n_resumed = len(completed)
    todo = [s for s in range(S) if s not in completed]
    keys = ("dice", "sdlogj", "neg_jac_frac", "hd95")
    cases = dict(dice=np.full((S, P, L), np.nan, np.float32),
                 sdlogj=np.full((S, P), np.nan, np.float32),
                 neg_jac_frac=np.full((S, P), np.nan, np.float32),
                 hd95=np.full((S, P), np.nan))
    scoring = None  # a sweep restored whole from its checkpoint prepares nothing
    if todo:
        robust30, scoring = _prepare(preds, segs, pairs, num_labels, compute_hd95, hd95_mode,
                                     dev, fan)
    for batch in fan.batches(todo):
        cells, secs = [], {}
        for s in fan.settings(batch):
            st = settings[s]
            _setting_sync(dev)
            t0, excluded = time.perf_counter(), 0.0
            for i in fan.pairs:
                with trace.span("sweep.convex", (s, i)):
                    field = convex_field_semantic(
                        scoring.preds[scoring.fi[i]], scoring.preds[scoring.mi[i]], st.nn_mult,
                        num_labels + 1, st.grid_sp, st.disp_hw, device=dev,
                    )
                out, t_ex = scoring.pair(s, i, [field])
                del field
                excluded += t_ex
                cells.append((s, i, *(v[0] for v in out)))
            secs[s] = time.perf_counter() - t0 - excluded
        _fill(cases, times, fan.gather((cells, secs)), keys)
        for s in batch:
            d = cases["dice"][s]
            dice[s, 0] = d.mean()
            dice[s, 1] = np.mean([d[i, robust30[i]].mean() for i in range(P)])
            jstd[s, 0] = cases["sdlogj"][s].mean()
            jstd[s, 1] = cases["neg_jac_frac"][s].mean()
            if compute_hd95:
                hd[s] = cases["hd95"][s].mean()
            if verbose and fan.lead:
                print(f"s={s} {settings[s]} dice={dice[s, 0]:.4f}/{dice[s, 1]:.4f} "
                      f"jstd={jstd[s, 0]:.4f} hd95={hd[s]:.3f} t={times[s]:.2f}s")
            completed.add(s)
        if fan.lead:
            _save(ck, arrays, completed)

    # sort_rank gives rank 1.0 to the SMALLEST value → negate the
    # higher-is-better metrics (convex_run_withconfig.py:162-169); HD95
    # takes part only when computed (ranking a placeholder of zeros would
    # favour low setting indices)
    ranks = [sort_rank(-dice[:, 0]), sort_rank(-dice[:, 1]), sort_rank(jstd[:, 0])]
    if compute_hd95:
        ranks.insert(2, sort_rank(hd))
    rank1 = rank_product(ranks)
    rescored, rescore_sec = _audit(fan, scoring)
    return SweepResult(dice, jstd, hd, times, rank1, int(rank1.argmax()),
                       rescored, rescore_sec, cases, n_resumed)


def _prepare(preds, segs, pairs, num_labels, compute_hd95, hd95_mode, dev, fan):
    """What both semantic stages prepare once a call: the :class:`_Scoring`
    of this rank's pairs, the robust-30 label sets and the loaded kernels.
    The robust-30 sets are host work after the scoring's last launches, so
    the card's idle stretch while the host makes them begins inside their
    span (a trace names an idle stretch by the host's range as it
    begins)."""
    with trace.span("sweep.prep"):
        scoring = _Scoring(np.asarray(preds, np.int32), np.asarray(segs, np.int32), pairs,
                           num_labels, compute_hd95, hd95_mode, dev, own=fan.pairs)
        with trace.span("sweep.prep.robust30"):
            robust30 = _robust30_label_sets(segs, pairs, num_labels)
        _load_kernels(dev)
    return robust30, scoring


def _audit(fan: _Fanout, scoring: "_Scoring | None") -> "tuple[int, float]":
    """The cap-overflow audit summed over the ranks (none where nothing
    ran)."""
    parts = fan.gather((0, 0.0) if scoring is None else (scoring.rescored, scoring.rescore_sec))
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


# ---------------------------------------------------------------------------
# stage 2
# ---------------------------------------------------------------------------

def _cost_scale(pred_fixed: torch.Tensor, pred_moving: torch.Tensor, num_labels: int) -> float:
    """The data term's scale: the count of labels present in either volume
    (the sweep's ``n_ch``, adam_run_withconfig_shiftSpline.py:195,229)."""
    counts = label_counts(pred_fixed, num_labels + 1) + label_counts(pred_moving, num_labels + 1)
    return float((counts > 0).sum())


def _stage2_variants(
    pred_fixed: torch.Tensor,
    pred_moving: torch.Tensor,
    disp_lr_coarse: torch.Tensor,
    nn_mult: float,
    lambda_weight: float,
    grid_sp_adam: int,
    avg_n: int,
    num_labels: int,
    cost_scale: float,
    feat_dtype: str = "auto",
):
    """One pair x one Adam setting (adam_run_withconfig_shiftSpline.py:175-263):
    Adam from the cached coarse convex field for 120 iterations with the
    smoother bank's ``avg_n`` entry, then yields the 16 full-resolution
    fields (3, H, W, D) in (snapshot, extra smoothing) order: each snapshot
    of :data:`STAGE2_SNAPSHOT_ITERS` with 0-3 extra 3^3 box passes.

    ``feat_dtype``: precision of the Adam features, "auto" (bfloat16 on the
    card, float32 on the CPU: the policy of
    ``ConvexAdamConfig.compute_dtype``), "float32" or "bfloat16"."""
    shape = tuple(pred_fixed.shape)
    cfg = ConvexAdamConfig(grid_sp_adam=grid_sp_adam, dtype=feat_dtype)
    with torch.no_grad():
        ff, fm = semantic_features(
            pred_fixed, pred_moving, num_labels=num_labels + 1, mult=1.0,
            dtype=cfg.compute_dtype(pred_fixed.device),
        )
        ff, fm = ff * nn_mult, fm * nn_mult
        disp_hr0 = resize_trilinear(disp_lr_coarse, shape, align_corners=False)
        patch_fix, patch_mov, init = _adam_inputs(ff, fm, disp_hr0, cfg)
    del ff, fm, disp_hr0
    # the caller may iterate under no_grad; the Adam loop needs autograd
    with torch.enable_grad(), trace.span("sweep.adam"):
        _, snaps = adam_instance_optimisation(
            patch_fix, patch_mov, init, lambda_weight, niter=120,
            snapshot_iters=STAGE2_SNAPSHOT_ITERS, smoother=("bank", avg_n),
            cost_scale=cost_scale,
        )
    del patch_fix, patch_mov, init
    for snap in snaps:  # detached snapshots
        with trace.span("sweep.variants"):
            disp_hr = _upsample_and_smooth(snap, shape, grid_sp_adam, 0)
        for kk in range(STAGE2_SMOOTH_LEVELS):
            if kk > 0:
                with trace.span("sweep.variants"):
                    disp_hr = box_smooth_repeated(disp_hr, 3, 1)
            yield disp_hr


@_recorded
def run_stage2_sweep(
    preds: np.ndarray,
    segs: np.ndarray,
    pairs: Sequence[tuple],
    convex_setting: Stage1Setting,
    adam_settings: Sequence[Stage2Setting],
    num_labels: int,
    compute_hd95: bool = True,
    verbose: bool = False,
    checkpoint_path=None,
    mesh: "Mesh | None" = None,
    setting_batch: "int | None" = None,
    resume: bool = False,
    hd95_mode: "str | None" = None,
    feat_dtype: str = "auto",
    device: "str | torch.device | None" = None,
) -> SweepResult:
    """Stage-2 semantic sweep: cache the coarse convex field of each pair at
    ``convex_setting`` (pass A), then run every Adam setting x 16 evaluation
    variants (pass B) and rank over the flattened S x 16 grid
    (adam_run_withconfig_shiftSpline.py:43-307); the metric arrays come
    back flattened to (S * 16, ...).  Arguments as
    :func:`run_stage1_sweep`; with a ``mesh`` each rank caches the fields of
    its own pairs only.  ``feat_dtype`` as :func:`_stage2_variants`.
    ``compute_hd95`` defaults True like stage 1: the reference's rank always
    includes HD95 (adam_run_withconfig_shiftSpline.py:276)."""
    dev = _sweep_device(device, mesh)
    trace.on_device(dev)
    pairs = list(pairs)
    P, L = len(pairs), num_labels
    fan = _Fanout(mesh, P, setting_batch)
    S = len(adam_settings)
    arrays = dict(dice=np.zeros((S, 4, 4, 2)), jstd=np.zeros((S, 4, 4, 2)),
                  hd95=np.zeros((S, 4, 4)), times=np.zeros(S))
    dice, jstd, hd, times = arrays["dice"], arrays["jstd"], arrays["hd95"], arrays["times"]
    ck, completed = _restore(checkpoint_path, resume, arrays)
    n_resumed = len(completed)
    todo = [s for s in range(S) if s not in completed]
    keys = ("dice", "sdlogj", "neg_jac_frac", "hd95")
    cases = dict(dice=np.full((S, P, 4, 4, L), np.nan, np.float32),
                 sdlogj=np.full((S, P, 4, 4), np.nan, np.float32),
                 neg_jac_frac=np.full((S, P, 4, 4), np.nan, np.float32),
                 hd95=np.full((S, P, 4, 4), np.nan))
    scoring = None  # a sweep restored whole from its checkpoint prepares nothing
    if todo:
        robust30, scoring = _prepare(preds, segs, pairs, num_labels, compute_hd95, hd95_mode,
                                     dev, fan)
        pf = [scoring.preds[f] for f in scoring.fi]
        pm = [scoring.preds[m] for m in scoring.mi]
        # pass A: the coarse convex fields, and each pair's data-term scale
        with trace.span("sweep.convex"):
            disps_lr = {
                i: convex_field_semantic(pf[i], pm[i], convex_setting.nn_mult, num_labels + 1,
                                         convex_setting.grid_sp, convex_setting.disp_hw,
                                         coarse=True, device=dev)
                for i in fan.pairs
            }
        scales = {i: _cost_scale(pf[i], pm[i], num_labels) for i in fan.pairs}
    for batch in fan.batches(todo):
        cells, secs = [], {}
        for s in fan.settings(batch):
            st = adam_settings[s]
            _setting_sync(dev)
            t0, excluded = time.perf_counter(), 0.0
            for i in fan.pairs:
                fields = _stage2_variants(
                    pf[i], pm[i], disps_lr[i], convex_setting.nn_mult, st.lambda_weight,
                    st.grid_sp_adam, st.effective_avg_n, num_labels, scales[i], feat_dtype,
                )
                out, t_ex = scoring.pair(s, i, fields)
                excluded += t_ex
                cells.append((s, i, *(v.reshape((4, 4) + v.shape[1:]) for v in out)))
            secs[s] = time.perf_counter() - t0 - excluded
        _fill(cases, times, fan.gather((cells, secs)), keys)
        for s in batch:
            dg = cases["dice"][s]  # (P, 4, 4, L)
            dice[s, :, :, 0] = dg.mean(axis=(0, 3))
            dice[s, :, :, 1] = np.mean(
                [dg[i][:, :, robust30[i]].mean(-1) for i in range(P)], axis=0
            )
            jstd[s, :, :, 0] = cases["sdlogj"][s].mean(0)
            jstd[s, :, :, 1] = cases["neg_jac_frac"][s].mean(0)
            if compute_hd95:
                hd[s] = cases["hd95"][s].mean(0)
            if verbose and fan.lead:
                print(f"s={s} {adam_settings[s]} best dice={dice[s, ..., 0].max():.4f} "
                      f"t={times[s]:.2f}s")
            completed.add(s)
        if fan.lead:
            _save(ck, arrays, completed)

    flat_hd = hd.reshape(-1)
    # as in stage 1, HD95 is ranked only when computed
    ranks2 = [
        sort_rank(-dice[..., 0].reshape(-1)),
        sort_rank(-dice[..., 1].reshape(-1)),
        sort_rank(jstd[..., 0].reshape(-1)),
    ]
    if compute_hd95:
        ranks2.append(sort_rank(flat_hd))
    rank2 = rank_product(ranks2)
    rescored, rescore_sec = _audit(fan, scoring)
    return SweepResult(
        dice.reshape(S * 16, 2), jstd.reshape(S * 16, 2), flat_hd, times, rank2,
        int(rank2.argmax()), rescored, rescore_sec, cases, n_resumed,
    )
