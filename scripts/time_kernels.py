#!/usr/bin/env python3
"""Device and call times of the MIND, cost-volume, sampler and data-term
kernels on a CUDA card.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 scripts/time_kernels.py [--root DIR] [--check] [--sass] [--only cost_volume|mind]

``--root`` imports ``convexadam_torch`` from another checkout (for example
an unpacked parent commit), so two versions of the kernels can be timed in
one run of the card, in turns.  On inputs from ``chip_smoke.py``'s own case
generators (``mind_cases``, ``cost_volume_cases``, ``adam_sampler_cases`` and
``data_term_cases`` of this checkout, seed 0) it times
``mind_ssd_stats`` (the 192^3 headline volume in bfloat16, r = 1, d = 2),
``cost_volume`` (the default 12 x 32^3 at q = 4, the semantic grid 14 x 32
x 26 x 42 at q = 4, the sweep's 12 x 64 x 53 x 85 at q = 7, and Learn2Reg
task 1's coarse grid 12 x 48 x 40 x 48 at q = 8, SSD, SAD and one candidate
block, the middle kh),
``sample_trilinear`` (the semantic Adam grid 14 x 96 x 80 x 128 with
bfloat16 and float32 volumes, with ``F.grid_sample`` on the float32 volume
beside it) and ``warp_ssd_loss_grad`` (the 12 x 96^3 Adam grid with
bfloat16 and float32 moving features, and the semantic Adam grid in
bfloat16), the three HD95 searches ``nearest_sq``, ``nearest_sq_dual`` and
``nearest_sq_pruned`` on phase 3e's label-surface and 65536-point cases
(``search_cases``), and the searches of each label bucket of phase 4c's
13-organ pair (``hd95_from_buffers`` on the zero-field pair's label buffers:
the searches, the percentiles and their sort; with the pruned search and
with it switched off), with ``chip_smoke.py``'s two figures: ``call_ms``,
the median CUDA-event time of one call, and ``device_ms``, the device time
per call of every kernel the call runs (``torch.profiler``; for the
searches, of the search kernels, with their launches a call).  It prints one
JSON line with the card's name and power limit.

``--check`` first runs ``chip_smoke.py``'s ptxas report (registers and
spills of ``mind.cu``, ``warp.cu``, ``cost_volume.cu`` and ``edt.cu``) and
its phases 3a, 3b, 3c's sampler, 3d, 3e and 3f on this checkout's package
(every comparison to the bit): the short first call for an edited kernel.

``--threshold`` instead measures, for this checkout only, where the pruned
search stops paying: one spherical organ against its copy rolled by the
headline shift, smooth (the pruned search's best case) and speckled (2% of
the volume's voxels flipped, a noisy prediction: its hard case), each sized
so that its larger surface list fills about 85% of the bucket K (16384 to
2097152), its ``hd95_from_buffers`` with the batched pruned search and with
the dual + tiled searches, call time, device time of the search kernels
(and of the tiled kernel alone), launches and the peak memory the call
adds.
``--only cost_volume`` builds ``cost_volume.cu`` alone and times only the
cost volumes (the default case on seeded 12 x 32^3 features, not pooled
MIND ones), with ptxas's registers and spills of its kernels: the quick
comparison of two versions of that kernel.
``--only mind`` builds ``mind.cu`` alone and times ``mind_ssd_stats`` on the
192^3 headline volume at the main path's (1, 2) in bfloat16 and at
``chip_smoke.py``'s ``MIND_TIMED`` pairs (the general kernel at (4, 1) in
bfloat16 and float32, (1, 5) and (6, 6) in bfloat16, the compiled (3, 3)
beside them), each with the MIND kernels the profiler saw (an older
checkout may launch another kernel than the pair's, or refuse the pair: the
error is recorded), with ptxas's registers and spills of ``mind.cu``.
``--sass`` also counts the machine instructions (``cuobjdump -sass``) of
the compile-time MIND kernels, the data term, the sampler and the
cost-volume kernels as built for ``--root``; in the fully unrolled MIND
kernels that is close to what a thread executes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=pathlib.Path, default=ROOT)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--threshold", action="store_true")
    ap.add_argument("--only", choices=("cost_volume", "mind"))
    args = ap.parse_args()
    if (args.check or args.threshold) and args.root.resolve() != ROOT:
        ap.error("--check and --threshold run on this checkout's package only")
    # the inputs and timing helpers come from this checkout, the package from --root
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    sys.path.insert(0, str(args.root.resolve()))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import convexadam_torch
    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import _build
    from convexadam_torch.kernels.cost_volume import cost_volume, cost_volume_block
    from convexadam_torch.kernels.mind import mind_ssd_stats
    from convexadam_torch.kernels.warp import sample_trilinear, warp_ssd_loss_grad

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build_all((args.only,) if args.only else _build.KERNEL_SOURCES)
    dev = torch.device("cuda")
    res = {"card": smi, "package": str(pathlib.Path(convexadam_torch.__file__).parent)}
    if args.only == "mind":
        res["mind"] = time_mind(torch, cs, dev, resize_trilinear, mind_ssd_stats)
        res["mind_ptxas"] = _build.resource_usage("mind")
        print(json.dumps(res))
        return 0
    if args.threshold:
        res["threshold"] = threshold_sweep(torch, cs, dev)
        print(json.dumps(res))
        return 0
    vol_np, mov_np = cs.headline_pair(torch, resize_trilinear)
    vol = torch.from_numpy(vol_np).to(dev)
    feats = [mindssc(torch.from_numpy(v).to(dev), 1, 2, dtype=torch.bfloat16)
             for v in (vol_np, mov_np)]

    # the main path's cost-volume inputs: the MIND features pooled by grid_sp 6
    fix_s, mov_s = (avg_pool3d(f, 6).float().contiguous() for f in feats)

    if args.check:
        cs.ptxas_report(_build)
        *_, res["mind_check"] = cs.mind_phase(torch, vol)
        _, res["cost_volume_check"] = cs.cost_volume_phase(torch, fix_s, mov_s, 4)
        gen = torch.Generator().manual_seed(0)
        _, res["sampler_check"] = cs.sampler_phase(torch, dev, gen, tuple(fix_s.shape[1:]))
        _, res["data_term_check"] = cs.data_term_phase(torch, gen, *feats, 2)
        _, res["search_check"] = cs.search_phase(torch, dev, *cs.l2r_label_pair())
        _, res["sampler_bwd_check"] = cs.sampler_bwd_phase(torch, dev, gen)

    if args.sass:
        cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
        res["sass_instructions"] = {}
        for src, kernel in (("mind", "mind_kernel"), ("warp", "warp_ssd_kernel"),
                            ("warp", "sample_trilinear_kernel"), ("cost_volume", "cost_volume")):
            sass = subprocess.run([str(cuobjdump), "-sass", str(_build._lib_path(src))],
                                  capture_output=True, text=True, check=True).stdout
            for body in re.split(r"\n\s+Function : ", sass)[1:]:
                name = body.split("\n", 1)[0].strip()
                if kernel in name:
                    res["sass_instructions"][name] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s", body))

    def timed(fn, kernels=None):
        t = {"call_ms": cs.cuda_ms(torch, fn), **cs.device_times(torch, fn, kernels)}
        return {k: t[k] for k in ("call_ms", "device_ms", "device_launches")}

    def time_cost_volumes(fix_s, mov_s):
        for what, q, fix, mov in cs.cost_volume_cases(torch, fix_s, mov_s, 4):
            if what == "ragged":
                break
            res[f"cost_volume {what} {tuple(fix.shape)} q={q}"] = timed(
                lambda: cost_volume(fix, mov, q))
        # task 1's q = 8: SSD, SAD, and the middle kh's candidate block
        gen = torch.Generator().manual_seed(2)
        fix, mov = (torch.randn(cs.COST_VOLUME_TASK1, generator=gen).to(dev) for _ in range(2))
        key = f"{tuple(fix.shape)} q={cs.TASK1_Q}"
        for metric in ("ssd", "sad"):
            res[f"cost_volume task1 {key} {metric}"] = timed(
                lambda: cost_volume(fix, mov, cs.TASK1_Q, metric))
        res[f"cost_volume_block task1 {key} kh={cs.TASK1_Q}"] = timed(
            lambda: cost_volume_block(fix, mov, cs.TASK1_Q, cs.TASK1_Q, 1))
        res["cost_volume_ptxas"] = _build.resource_usage("cost_volume")

    if args.only == "cost_volume":
        # no MIND kernel: seeded features at the main path's shape (the
        # kernel's time does not depend on the values)
        gen = torch.Generator().manual_seed(0)
        time_cost_volumes(*(torch.randn((12, 32, 32, 32), generator=gen).to(dev)
                            for _ in range(2)))
        print(json.dumps(res))
        return 0

    # the HD95 searches first: they need little memory of their own
    import convexadam_torch.core.edt as tedt
    from convexadam_torch.kernels import edt as ke

    cases, groups, caps, bufs = cs.search_cases(torch, dev, *cs.l2r_label_pair())
    for cname in ("surface", "large"):
        c = cases[cname]
        q, t, t_out = c["q"], c["t"], c["t_out"]
        key = f"{cname} {tuple(q.shape)}"
        res[f"nearest_sq {key}"] = timed(
            lambda: ke.nearest_sq(q, t_out, c["hq"], c["nt_out"]), cs.GLOBALS["nearest_sq"])
        res[f"nearest_sq_dual {key}"] = timed(
            lambda: ke.nearest_sq_dual(q, t, c["nq"], c["nt"], c["hq"], c["ht"]),
            cs.GLOBALS["nearest_sq_dual"])
        res[f"nearest_sq_pruned {key}"] = timed(
            lambda: ke.nearest_sq_pruned(q, t, c["hq"], c["nq"], c["nt"]),
            cs.GLOBALS["nearest_sq_pruned"])
    searches = ("nearest_sq_kernel", "nearest_sq_dual_kernel", "nearest_sq_pruned_kernel")
    enabled = tedt._pruned_search_enabled
    for labs, K in groups:
        for branch, rule in (("pruned", enabled), ("pruned off", lambda k: False)):
            tedt._pruned_search_enabled = rule
            try:
                res[f"hd95 searches K={K} ({len(labs)} labels), {branch}"] = timed(
                    lambda: tedt.hd95_from_buffers(bufs, caps, K, 30.0, labs), searches)
                if branch == "pruned off":
                    res[f"hd95 searches K={K} ({len(labs)} labels), pruned off, tiled kernel"] = (
                        timed(lambda: tedt.hd95_from_buffers(bufs, caps, K, 30.0, labs),
                              cs.GLOBALS["nearest_sq"]))
            finally:
                tedt._pruned_search_enabled = enabled
    del cases, bufs

    shape, dt, r, d, x = next(cs.mind_cases(torch, vol))
    res[f"mind_ssd_stats {shape} {dt} (r, d) = {(r, d)}"] = timed(lambda: mind_ssd_stats(x, r, d))
    time_cost_volumes(fix_s, mov_s)
    gen = torch.Generator().manual_seed(0)
    for C, shape, dt, svol, grid, _ in cs.adam_sampler_cases(torch, dev, gen):
        if C == cs.SEMANTIC_LABELS:
            res[f"sample_trilinear {(1, C, *shape)} {dt}"] = timed(lambda: sample_trilinear(svol, grid))
            if dt == torch.float32:
                g5 = grid.flip(-1).reshape(1, 1, 1, -1, 3)
                res[f"F.grid_sample {(1, C, *shape)} {dt}"] = timed(
                    lambda: F.grid_sample(svol, g5, align_corners=False))
    gen = torch.Generator().manual_seed(0)
    for what, fix, mov, disp, fac, chain in cs.data_term_cases(torch, gen, *feats, 2):
        if what != "ragged":
            res[f"warp_ssd_loss_grad {what} {tuple(mov.shape)} {mov.dtype}"] = timed(
                lambda: warp_ssd_loss_grad(mov, disp, fix, fac, chain))
    print(json.dumps(res))
    return 0


def time_mind(torch, cs, dev, resize_trilinear, mind_ssd_stats) -> dict:
    """Call and device time of ``mind_ssd_stats`` on the 192^3 headline
    volume at (1, 2) in bfloat16 and at every pair of ``cs.MIND_TIMED``,
    with the names of the MIND kernels each call ran."""
    vol_np, _ = cs.headline_pair(torch, resize_trilinear)
    vol = torch.from_numpy(vol_np).to(dev)
    out = {}
    for (r, d), dt in [((1, 2), "bfloat16")] + cs.MIND_TIMED:
        x = vol.to(getattr(torch, dt)).contiguous()
        key = f"{tuple(x.shape)} {dt} (r, d) = {(r, d)}"
        try:
            def fn():
                return mind_ssd_stats(x, r, d)

            t = {"call_ms": cs.cuda_ms(torch, fn),
                 **cs.device_times(torch, fn, ("mind_kernel", "mind_general_kernel"))}
            out[key] = {k: t[k] for k in ("call_ms", "device_ms", "device_launches",
                                          "device_kernels")}
        except (RuntimeError, AssertionError) as e:
            out[key] = {"error": str(e)}
        print(key, out[key], flush=True)
    return out


def sphere_pair(torch, dev, K: int, shift=(5, -4, 3)):
    """One spherical organ whose surface fills about 85% of a bucket of K
    points (a voxel sphere of radius r has about 10.5 r^2 face-boundary
    voxels), and its copy rolled by ``shift``, on the card."""
    r = int((0.85 * K / 10.5) ** 0.5)
    n = 2 * r + 24
    ax = torch.arange(n, device=dev, dtype=torch.float32) - n / 2
    zz, yy, xx = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    seg = ((zz * zz + yy * yy + xx * xx) <= r * r).to(torch.int32)
    return seg, torch.roll(seg, shift, dims=(0, 1, 2)), r


def speckled_pair(torch, dev, K: int, rate=0.02, shift=(5, -4, 3)):
    """One spherical organ, and its copy rolled by ``shift`` with ``rate``
    of the volume's voxels flipped (seed 0, on the card): a speckled
    predicted segmentation, whose surface is mostly isolated voxels spread
    over the volume.  The radius is refitted until the larger of the
    speckled copy's two surface lists fills 75-95% of a bucket of K
    points."""
    import convexadam_torch.core.edt as tedt

    # a flipped voxel adds about six points to one surface list
    r = int((0.85 * K / (27 * rate)) ** (1 / 3))
    for _ in range(8):
        n = 2 * r + 24
        ax = torch.arange(n, device=dev, dtype=torch.float32) - n / 2
        zz, yy, xx = ax[:, None, None], ax[None, :, None], ax[None, None, :]
        seg = ((zz * zz + yy * yy + xx * xx) <= r * r).to(torch.int32)
        g = torch.Generator(device=dev).manual_seed(0)
        flip = torch.rand(seg.shape, generator=g, device=dev) < rate
        mov = torch.where(flip, 1 - seg, seg).roll(shift, dims=(0, 1, 2))
        pre = tedt.surface_lists(seg, mov, 1, 8 * K)
        bufs = tedt.label_buffers(pre, 1, (0, 4 * K))
        most = max(int(bufs.n_inner_m[1]), int(bufs.n_outer_m[1]),
                   int(bufs.n_inner_f[1]), int(bufs.n_outer_f[1]))
        if 0.75 * K <= most <= 0.95 * K:
            break
        r = int(r * (0.85 * K / most) ** (1 / 3))
    return seg, mov, r


def threshold_sweep(torch, cs, dev) -> list:
    """``hd95_from_buffers`` of one organ, smooth and speckled, with the
    batched pruned search and with the dual + tiled searches at K = 16384 to
    2097152: the measurement behind ``_pruned_search_enabled``."""
    import convexadam_torch.core.edt as tedt

    searches = ("nearest_sq_kernel", "nearest_sq_dual_kernel", "nearest_sq_pruned_kernel")
    enabled = tedt._pruned_search_enabled
    rows = []
    cases = [(organ, pair, K)
             for organ, pair in (("sphere", sphere_pair), ("speckled", speckled_pair))
             for K in (16384, 65536, 131072, 262144, 524288, 1048576, 2097152)]
    for organ, pair, K in cases:
        seg_f, seg_m, r = pair(torch, dev, K)
        caps = (0, K)
        pre = tedt.surface_lists(seg_f, seg_m, 1, 4 * K)
        bufs = tedt.label_buffers(pre, 1, caps)
        del seg_f, seg_m, pre
        row = {"organ": organ, "K": K, "radius": r, "n_inner_f": int(bufs.n_inner_f[1]),
               "n_outer_f": int(bufs.n_outer_f[1]), "n_inner_m": int(bufs.n_inner_m[1]),
               "n_outer_m": int(bufs.n_outer_m[1]),
               "overflow": bool(max(int(bufs.n_inner_f[1]), int(bufs.n_outer_f[1]),
                                    int(bufs.n_inner_m[1]), int(bufs.n_outer_m[1])) > K)}
        hd = {}
        for branch, rule in (("pruned", lambda k: True), ("dual_tiled", lambda k: False)):
            tedt._pruned_search_enabled = rule
            try:
                def run():
                    return tedt.hd95_from_buffers(bufs, caps, K, 30.0, (1,))

                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                hd[branch] = float(run()[0])
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                reps = 3 if K >= 262144 else 10
                t = {"call_ms": cs.cuda_ms(torch, run, warmup=1, reps=reps),
                     **cs.device_times(torch, run, searches, warmup=1, reps=reps)}
                row[branch] = {"call_ms": t["call_ms"], "device_ms": t["device_ms"],
                               "device_launches": t["device_launches"],
                               "peak_added_mb": peak / 1e6}
                if branch == "dual_tiled":
                    row[branch]["tiled_device_ms"] = cs.device_times(
                        torch, run, cs.GLOBALS["nearest_sq"], warmup=1, reps=reps)["device_ms"]
            finally:
                tedt._pruned_search_enabled = enabled
        row["hd95_equal"] = hd["pruned"] == hd["dual_tiled"]
        row["hd95"] = hd["pruned"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del bufs
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    sys.exit(main())
