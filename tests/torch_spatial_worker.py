"""One rank of the four-rank runs of ``tests/test_torch_spatial.py``.

Run as ``python -m tests.torch_spatial_worker OUT_DIR`` from the repository
root, with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (4)
set: it joins a gloo process group on the CPU (60 s timeout, one thread a
rank), runs the halo exchanges and gathers on known tensors, every config of
:data:`CONFIGS` split over a (pair 1, space 4) grid, stage by stage, the
(pair 2, space 2) grid, a 44-row volume and a volume too short for four
slabs; rank ``k`` also computes the one-process references of the configs
``k, k + 4, ...``.  Results go to ``OUT_DIR/rank<RANK>.pkl``.  It imports
no JAX.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
from scipy.ndimage import uniform_filter

SHAPE = (48, 32, 32)
SHORT_SHAPE = (44, 32, 32)
SHIFT = (2, -1, 1)
BASE = dict(grid_sp=4, disp_hw=2, selected_niter=10, grid_sp_adam=2)
# (name, overrides of BASE): satellite configs of the spatial path
CONFIGS = (
    ("default", {}),
    ("no_ic", {"ic": False}),
    ("sad_one_pass", {"cost_metric": "sad", "cost_smooth_passes": 1}),
    ("smooth5", {"selected_smooth": 5}),
    ("gauss1", {"adam_smoother": ("gauss", 1.0)}),
    ("kovesi1.9", {"adam_smoother": ("kovesi", 1.9)}),
    ("stride2", {"adam_sample_stride": 2}),
    ("no_adam", {"lambda_weight": 0.0}),
)
# known tensors of the exchange tests: rows per rank (uneven, a rank of one
# row) and the (lo, hi) halos taken, one spanning several ranks
EXCHANGE_ROWS = (3, 4, 1, 3)
EXCHANGE_HALOS = ((1, 2), (0, 0), (5, 5), (2, 0))


def config(name: str):
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

    return ConvexAdamConfig(**BASE, **dict(CONFIGS)[name])


def volume(shape=SHAPE, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (uniform_filter(rng.standard_normal(shape).astype(np.float32), 3) * 100).astype(
        np.float32)


def pairs(shape=SHAPE, n: int = 1):
    """``n`` smooth volumes and their copies rolled by :data:`SHIFT`."""
    vols = np.stack([volume(shape, seed) for seed in range(n)])
    return vols, np.roll(vols, SHIFT, axis=(1, 2, 3))


def exchange_ranges():
    starts = np.cumsum((0,) + EXCHANGE_ROWS)
    return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]


def known(dtype=torch.float32) -> torch.Tensor:
    """(2, rows, 3, 2): each value its own flat index."""
    n = sum(EXCHANGE_ROWS)
    return torch.arange(2 * n * 6, dtype=torch.float32).reshape(2, n, 3, 2).to(dtype)


def one_process_stages(fix: torch.Tensor, mov: torch.Tensor, cfg) -> dict:
    """The stages of ``convex_adam_torch`` on one process, composed of the
    pipeline's own functions, as ``register_slab`` records them."""
    from convexadam_torch.core.adam import adam_instance_optimisation
    from convexadam_torch.core.convex import convex_displacement
    from convexadam_torch.core.features import mindssc
    from convexadam_torch.core.smoothing import avg_pool3d
    from convexadam_torch.core.warp import inverse_consistency
    from convexadam_torch.pipeline import convex_adam as pipe

    dt = cfg.compute_dtype(fix.device)
    out: dict = {}
    with torch.no_grad():
        ff, fm = (mindssc(x, cfg.mind_r, cfg.mind_d, dtype=dt) for x in (fix, mov))
        out["features"] = (ff, fm)
        fs, ms = avg_pool3d(ff, cfg.grid_sp), avg_pool3d(fm, cfg.grid_sp)
        kw = dict(metric=cfg.cost_metric, smooth_passes=cfg.cost_smooth_passes)
        soft = convex_displacement(fs, ms, cfg.disp_hw, **kw)
        if cfg.ic:
            soft_r = convex_displacement(ms, fs, cfg.disp_hw, **kw)
            out["convex"] = (soft, soft_r)
            h, w, d = soft.shape[1:]
            scale = torch.tensor([(h - 1) / 2.0, (w - 1) / 2.0, (d - 1) / 2.0]).reshape(3, 1, 1, 1)
            out["ic"] = inverse_consistency(soft / scale, soft_r / scale, iters=15)[0]
        else:
            out["convex"] = (soft,)
        if cfg.lambda_weight > 0:
            init = pipe._convex_stage(ff, fm, cfg, tuple(fix.shape), for_adam_init=True)
    if cfg.lambda_weight > 0:
        pf, pm, dinit = pipe._adam_inputs(ff, fm, init, cfg)
        out["adam"] = adam_instance_optimisation(
            pf, pm, dinit, lambda_weight=cfg.lambda_weight, niter=cfg.selected_niter,
            smoother=cfg.adam_smoother, sample_stride=cfg.adam_sample_stride)[0]
    out["final"] = pipe.convex_adam_torch(fix, mov, cfg)
    return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple) else v.detach().numpy()
            for k, v in out.items()}


def main(out_dir: str) -> int:
    import torch.distributed as dist

    from convexadam_torch.parallel import spatial
    from convexadam_torch.parallel.batch import make_mesh, register_pairs_sharded
    from convexadam_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    n = int(os.environ["WORLD_SIZE"])
    res: dict = {"joined": init_distributed(backend="gloo", timeout_s=60)}
    mesh = make_mesh(1, n, device="cpu")
    group = mesh.group("space")

    # (a) the exchanges on known tensors
    ranges = exchange_ranges()
    for dtype in (torch.float32, torch.bfloat16):
        x = known(dtype)
        mine = x[:, ranges[rank][0]:ranges[rank][1]]
        res[("gather", str(dtype))] = spatial.gather_rows(mine, ranges, group)
        for lo, hi in EXCHANGE_HALOS:
            res[("halo", str(dtype), lo, hi)] = spatial.exchange_halo(mine, lo, hi, ranges, group)

    # (b) every config stage by stage over (pair 1, space 4); this rank's
    # share of the one-process references
    vols, movs = pairs()
    fix, mov = torch.from_numpy(vols[0]), torch.from_numpy(movs[0])
    res["refs"], res["stages"], res["fields"] = {}, {}, {}
    for k, (name, _) in enumerate(CONFIGS):
        cfg = config(name)
        if k % n == rank:
            res["refs"][name] = one_process_stages(fix, mov, cfg)
        plan = spatial.slab_plan(SHAPE[0], spatial.slab_unit(cfg), n, mesh.coord("space"))
        a, b = plan.own()
        record: dict = {}
        final = spatial.register_slab(fix[a:b], mov[a:b], cfg, plan, group, record)
        record["final"] = final
        res["stages"][name] = {k2: tuple(t.numpy() for t in v) if isinstance(v, tuple)
                               else v.detach().numpy() for k2, v in record.items()}
        res["fields"][name] = register_pairs_sharded(vols, movs, cfg, mesh,
                                                     shard_space=True).numpy()
        res.setdefault("plans", {})[name] = plan.rows()

    # (c) the (pair 2, space 2) grid on two pairs, and (pair 1, space 4) at
    # 44 rows (slabs of 12, 12, 12 and 8)
    cfg = config("default")
    vols2, movs2 = pairs(n=2)
    res["grid22"] = register_pairs_sharded(vols2, movs2, cfg, make_mesh(2, n // 2, device="cpu"),
                                           shard_space=True).numpy()
    v44, m44 = pairs(SHORT_SHAPE)
    res["short"] = register_pairs_sharded(v44, m44, cfg, mesh, shard_space=True).numpy()
    if rank == 0:
        res["grid22_ref"] = np.stack([one_process_stages(torch.from_numpy(f), torch.from_numpy(m),
                                                         cfg)["final"]
                                      for f, m in zip(vols2, movs2)])
    if rank == 1:
        res["short_ref"] = one_process_stages(torch.from_numpy(v44[0]), torch.from_numpy(m44[0]),
                                              cfg)["final"]

    # (d) three units of 4 rows over four ranks
    tiny_f, tiny_m = pairs((12, 32, 32))
    try:
        register_pairs_sharded(tiny_f, tiny_m, cfg, mesh, shard_space=True)
        res["too_short"] = None
    except ValueError as e:
        res["too_short"] = str(e)
    res["traffic"] = dict(spatial.TRAFFIC)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
