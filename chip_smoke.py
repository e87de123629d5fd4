#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
  2. build: the CUDA kernels of ``convexadam_torch/csrc`` (one nvcc per source);
  3. kernels: each kernel against its plain PyTorch version on the card, at
     the main path's shapes and dtypes (and a ragged shape for the MIND and
     sampling kernels), with kernel / plain / library times (CUDA events,
     median of 20 runs after warm-up);
  4. main path: ``convex_adam`` with the default config on the 192^3 headline
     pair (seed 0, shift (5, -4, 3)): the shift must be recovered and every
     kernel launched (2 / 2 / 15 / 80 per registration); the golden 48^3
     fixture must stay inside the JAX package's f32 and bf16 envelopes;
  5. output: one JSON line per result, ``{"kernels": [...]}`` second to last,
     then ``{"ok": true, "device": {...}}`` last.

It imports nothing of JAX or of the JAX package, and exits non-zero without
a result when no CUDA device is visible.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM datasheet peaks: HBM bytes/s, f32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

HEADLINE_SHAPE = (192, 192, 192)
HEADLINE_SHIFT = (5, -4, 3)
EXPECTED_LAUNCHES = {
    "mind_ssd_stats": 2, "cost_volume": 2, "sample_trilinear": 15, "warp_ssd_loss_grad": 80,
}
REPLACES = {
    "mind_ssd_stats": "convexadam_tpu/ops/mind_pallas.py:196",
    "cost_volume": "convexadam_tpu/ops/cost_volume_pallas.py:96",
    "sample_trilinear": "convexadam_tpu/ops/warp_pallas.py:163",
    "warp_ssd_loss_grad": "convexadam_tpu/ops/warp_pallas.py:268",
}
SOURCES = {
    "mind_ssd_stats": "convexadam_torch/csrc/mind.cu",
    "cost_volume": "convexadam_torch/csrc/cost_volume.cu",
    "sample_trilinear": "convexadam_torch/csrc/warp.cu",
    "warp_ssd_loss_grad": "convexadam_torch/csrc/warp.cu",
}


def cuda_ms(torch, fn, warmup: int = 3, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float) -> "tuple[float, str]":
    tb = nbytes / PEAK_BYTES_S * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def headline_pair(torch, resize_trilinear, shape=HEADLINE_SHAPE, shift=HEADLINE_SHIFT, seed=0):
    """Smooth random texture and its copy rolled by ``shift`` (the JAX
    package's bench fixture, rebuilt with the port's resize)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal([s // 4 for s in shape]).astype(np.float32)
    vol = resize_trilinear(torch.from_numpy(base)[None], shape)[0].numpy()
    vol = (vol - vol.mean()) / vol.std() * 100
    return vol, np.roll(vol, shift, axis=(0, 1, 2))


def kernel_record(name, shape, dtype, err, tol, k_ms, p_ms, lib_ms, nbytes, flops):
    b_ms, b_by = bound_ms(nbytes, flops)
    return {
        "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
        "shape": shape, "dtype": dtype, "max_abs_err": err, "tol": tol,
        "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
        "bound_ms": b_ms, "bound_by": b_by,
    }


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    import torch.nn.functional as F

    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import resize_trilinear
    from convexadam_torch.kernels import LAUNCHES, _build, reset_launches
    from convexadam_torch.kernels.cost_volume import cost_volume, cost_volume_plain
    from convexadam_torch.kernels.mind import mind_ssd_stats, mind_ssd_stats_plain
    from convexadam_torch.kernels.warp import (
        sample_trilinear,
        sample_trilinear_plain,
        warp_ssd_loss_grad,
        warp_ssd_loss_grad_plain,
    )
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig, convex_adam

    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)
    results: dict = {}

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi}", flush=True)
    print(f"torch.cuda.get_device_name: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    results["card"] = {"nvidia_smi": smi, "name": kind}

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s", flush=True)
    results["build_s"] = build_s

    vol_np, mov_np = headline_pair(torch, resize_trilinear)
    vol = torch.from_numpy(vol_np).to(dev)
    records = []

    # 3a. MIND statistics: the main path's 192^3 bf16 volume, f32, and ragged
    for shape, dt in ((HEADLINE_SHAPE, torch.bfloat16), (HEADLINE_SHAPE, torch.float32),
                      ((37, 41, 29), torch.float32), ((37, 41, 29), torch.bfloat16)):
        x = vol[: shape[0], : shape[1], : shape[2]].to(dt).contiguous()
        mk, vk = mind_ssd_stats(x, 1, 2)
        mp, vp = mind_ssd_stats_plain(x, 1, 2)
        torch.cuda.synchronize()
        # the kernel repeats the plain version's operations in its order and
        # rounding (bf16 too): they must agree to the bit
        tol = 0.0
        err = max(max_err(mk, mp), max_err(vk, vp))
        check(err <= tol, f"mind_ssd_stats {shape} {dt}: max err {err} > {tol}")
        print(f"mind_ssd_stats {shape} {dt}: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
        if shape == HEADLINE_SHAPE and dt == torch.bfloat16:
            n = x.numel()
            k_ms = cuda_ms(torch, lambda: mind_ssd_stats(x, 1, 2))
            p_ms = cuda_ms(torch, lambda: mind_ssd_stats_plain(x, 1, 2))
            rec = kernel_record("mind_ssd_stats", list(shape), "bfloat16", err, tol, k_ms, p_ms,
                                None, n * 2 + 12 * n * 2 + n * 4, 145.0 * n)
            records.append(rec)

    # 3b. cost volume: pooled MIND features of the headline pair, 12 x 32^3, q = 4
    cfg = ConvexAdamConfig()
    feat_f = mindssc(vol, 1, 2, dtype=torch.bfloat16)
    feat_m = mindssc(torch.from_numpy(mov_np).to(dev), 1, 2, dtype=torch.bfloat16)
    fix_s = avg_pool3d(feat_f, cfg.grid_sp).float().contiguous()
    mov_s = avg_pool3d(feat_m, cfg.grid_sp).float().contiguous()
    ck = cost_volume(fix_s, mov_s, cfg.disp_hw)
    cp = cost_volume_plain(fix_s, mov_s, cfg.disp_hw)
    torch.cuda.synchronize()
    tol = 0.0  # same float32 operations in the same channel order: to the bit
    err = max_err(ck, cp)
    check(err <= tol, f"cost_volume: max err {err} > {tol}")
    print(f"cost_volume {tuple(fix_s.shape)}: max_abs_err {err:.3e} (tol {tol:.3e})", flush=True)
    C, h, w, d = fix_s.shape
    K3 = (2 * cfg.disp_hw + 1) ** 3
    n = h * w * d
    records.append(kernel_record(
        "cost_volume", [C, h, w, d, cfg.disp_hw], "float32", err, tol,
        cuda_ms(torch, lambda: cost_volume(fix_s, mov_s, cfg.disp_hw)),
        cuda_ms(torch, lambda: cost_volume_plain(fix_s, mov_s, cfg.disp_hw)),
        None, 2 * C * n * 4 + K3 * n * 4, 3.0 * K3 * n * C,
    ))

    # 3c. trilinear sampler: inverse consistency's 2 x 3 x 32^3, and ragged
    gen = torch.Generator(device="cpu").manual_seed(0)
    for shape in ((h, w, d), (37, 41, 29)):
        nvox = shape[0] * shape[1] * shape[2]
        fields = (torch.randn((2, 3) + shape, generator=gen) * 0.1).to(dev)
        ident = torch.stack(torch.meshgrid(
            *[(2 * torch.arange(s, dtype=torch.float32) + 1) / s - 1 for s in shape],
            indexing="ij"), -1).reshape(1, nvox, 3).to(dev)
        grid = (ident + fields.flip(0).permute(0, 2, 3, 4, 1).reshape(2, nvox, 3)).contiguous()
        sk = sample_trilinear(fields, grid)
        sp = sample_trilinear_plain(fields, grid)
        lib = F.grid_sample(fields, grid.flip(-1).reshape(2, 1, 1, nvox, 3), mode="bilinear",
                            padding_mode="zeros", align_corners=False).reshape(2, 3, nvox)
        torch.cuda.synchronize()
        err = max_err(sk, sp)
        tol = 0.0  # same weights and corner order: to the bit
        check(err <= tol, f"sample_trilinear {shape}: max err {err} > {tol}")
        lib_err = max_err(sk, lib)
        check(lib_err <= 1e-5, f"sample_trilinear {shape} vs F.grid_sample: {lib_err}")
        print(f"sample_trilinear {shape}: max_abs_err {err:.3e} (tol {tol:.1e}); "
              f"vs F.grid_sample {lib_err:.3e}", flush=True)
        if shape == (h, w, d):
            g5 = grid.flip(-1).reshape(2, 1, 1, nvox, 3)
            records.append(kernel_record(
                "sample_trilinear", [2, 3, *shape], "float32", err, tol,
                cuda_ms(torch, lambda: sample_trilinear(fields, grid)),
                cuda_ms(torch, lambda: sample_trilinear_plain(fields, grid)),
                cuda_ms(torch, lambda: F.grid_sample(fields, g5, align_corners=False)),
                2 * (2 * 3 * nvox * 4) + 2 * nvox * 3 * 4, 2.0 * nvox * (3 * 16 + 30),
            ))

    # 3d. Adam data term: the 96^3 x 12 Adam grid, bf16 moving features
    g2 = cfg.grid_sp_adam
    pf = avg_pool3d(feat_f.float(), g2).contiguous()
    C, H, W, D = pf.shape
    N = H * W * D
    pm = avg_pool3d(feat_m.float(), g2).to(torch.bfloat16).contiguous()
    fix_flat = pf.reshape(C, N)
    smooth = torch.randn((3, H // 8, W // 8, D // 8), generator=gen) * 2.0
    disp = resize_trilinear(smooth, (H, W, D)).to(dev).contiguous()
    fac = (H / (H - 1.0), W / (W - 1.0), D / (D - 1.0))
    chain = 2.0 * 12.0 / (C * N)
    ssq_k, rows_k = warp_ssd_loss_grad(pm, disp, fix_flat, fac, chain)
    ssq_p, rows_p = warp_ssd_loss_grad_plain(pm, disp, fix_flat, fac, chain)
    torch.cuda.synchronize()
    # sum(res^2): a fixed two-pass tree in the kernel, torch's own order in
    # the plain version, hence 1e-5 relative; the rows are the same
    # operations in the same order, to the bit
    ssq_rel = abs(float(ssq_k) - float(ssq_p)) / float(ssq_p)
    check(ssq_rel <= 1e-5, f"warp_ssd_loss_grad: sum(res^2) relative err {ssq_rel}")
    err = max_err(rows_k, rows_p)
    tol = 0.0
    check(err <= tol, f"warp_ssd_loss_grad rows: max err {err} > {tol}")
    print(f"warp_ssd_loss_grad {(C, H, W, D)} bf16: rows max_abs_err {err:.3e} (tol {tol:.3e}); "
          f"sum(res^2) rel err {ssq_rel:.3e}", flush=True)
    records.append(kernel_record(
        "warp_ssd_loss_grad", [C, H, W, D], "bfloat16", err, tol,
        cuda_ms(torch, lambda: warp_ssd_loss_grad(pm, disp, fix_flat, fac, chain)),
        cuda_ms(torch, lambda: warp_ssd_loss_grad_plain(pm, disp, fix_flat, fac, chain)),
        None, C * N * 2 + C * N * 4 + 3 * N * 4 * 2, 1.0 * N * (C * 74 + 60),
    ))
    del ck, cp, feat_f, feat_m

    # 4a. main path: default config on the headline pair
    convex_adam(vol_np, mov_np, device="cuda")  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    out = convex_adam(vol_np, mov_np, device="cuda")
    launches = dict(LAUNCHES)
    print(f"launches per registration: {launches}", flush=True)
    for name, want in EXPECTED_LAUNCHES.items():
        check(launches[name] == want, f"{name}: {launches[name]} launches, expected {want}")
    check(out.shape == HEADLINE_SHAPE + (3,) and bool(np.isfinite(out).all()), "bad field")
    c = 32
    err_v = np.abs(out[c:-c, c:-c, c:-c] - np.array(HEADLINE_SHIFT, np.float32))
    frac_ok = float(np.mean(np.all(err_v < 1.0, axis=-1)))
    check(frac_ok > 0.9, f"headline shift recovered in only {frac_ok:.2%} of the crop")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convex_adam(vol_np, mov_np, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    reg = {
        "shape": list(HEADLINE_SHAPE), "config": "default (dtype auto = bfloat16)",
        "frac_within_1vox": frac_ok, "mean_abs_err_vox": float(err_v.mean()),
        "registration_s_median": float(np.median(times)), "registration_s": times,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(f"registration 192^3: {reg['registration_s_median']:.4f} s (median of 3), "
          f"{frac_ok:.2%} of the crop within 1 voxel", flush=True)

    # 4b. golden 48^3 fixture: the JAX package's f32 and bf16 envelopes
    golden = np.load(ROOT / "tests" / "golden_disp_48.npz")
    gvol = golden["vol"].astype(np.float32)
    gmov = np.roll(gvol, tuple(golden["shift"]), axis=(0, 1, 2))
    gcfg = ConvexAdamConfig(grid_sp=4, disp_hw=2, lambda_weight=1.25, selected_niter=80,
                            grid_sp_adam=2)
    gref = golden["disp"].astype(np.float32)
    for dtype, med_lim, p99_lim, max_lim in (("float32", 0.05, 0.5, np.inf),
                                             ("bfloat16", 0.15, 0.75, 1.5)):
        gout = convex_adam(gvol, gmov, gcfg, device="cuda", dtype=dtype)
        epe = np.sqrt(((gout - gref) ** 2).sum(-1))
        med, p99 = float(np.median(epe)), float(np.quantile(epe, 0.99))
        check(med < med_lim and p99 < p99_lim and float(epe.max()) < max_lim,
              f"golden {dtype}: median {med:.4f} / p99 {p99:.4f} / max {epe.max():.4f} "
              f"outside {med_lim} / {p99_lim} / {max_lim}")
        reg[f"golden48_{dtype}"] = {"median_epe": med, "p99_epe": p99, "max_epe": float(epe.max())}
        print(f"golden 48^3 {dtype}: median {med:.4f}, p99 {p99:.4f}", flush=True)

    # 5. output
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        rec["launches_per_registration"] = launches[rec["name"]]
    results["registration"] = reg
    results["kernels"] = records
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"registration": reg}))
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
