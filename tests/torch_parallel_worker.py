"""One rank of the two-rank runs of ``tests/test_torch_parallel.py``.

Run as ``python -m tests.torch_parallel_worker OUT_DIR CLI_CONFIG`` from the
repository root, with ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and
``WORLD_SIZE`` set: it joins a gloo process group on the CPU (60 s timeout),
runs every multi-rank case of the test file on its inputs (defined here, so
that the test builds the same ones for its single-process references) and
writes its results to ``OUT_DIR/rank<RANK>.pkl``.  It imports no JAX.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist
from scipy.ndimage import uniform_filter

# (q, metric, box passes): q = 2 has 125 candidates, which 2 ranks hold as
# 63 + 62 and one padded copy of the last
TP_CASES = ((2, "ssd", 2), (1, "sad", 1))
TP_SHAPE = (4, 10, 12, 10)
# (n_setting, n_pair) grids of the two ranks
GRIDS = ((2, 1), (1, 2))
SWEEP_N = 18
SWEEP_PAIRS = [(0, 1), (1, 2), (2, 3)]  # three pairs: 2 + 1 along a pair axis of 2
PAIRED_N = 24
PAIRED_SHIFT = (2, -1, 1)
PAIRED_KPTS = (14, 9, 11)
CLI_SETTINGS = 3


def tp_features(seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(TP_SHAPE).astype(np.float32),
            rng.standard_normal(TP_SHAPE).astype(np.float32))


def sweep_dataset(K: int = 4, n: int = SWEEP_N, seed: int = 0):
    """K label volumes n^3 of two nested boxes shifted per subject;
    predictions = ground truth."""
    rng = np.random.default_rng(seed)
    a, b, c, d, r = (round(f * n) for f in (8 / 36, 26 / 36, 13 / 36, 21 / 36, 3 / 36))
    segs = []
    for _ in range(K):
        seg = np.zeros((n, n, n), np.int32)
        o = rng.integers(-r, r + 1, 3)
        seg[a + o[0]: b + o[0], a + o[1]: b + o[1], a + o[2]: b + o[2]] = 1
        seg[c + o[0]: d + o[0], c + o[1]: d + o[1], c + o[2]: d + o[2]] = 2
        segs.append(seg)
    segs = np.stack(segs)
    return segs, segs.copy()


def stage1_settings():
    from convexadam_torch.selfconfig.settings import Stage1Setting

    return [Stage1Setting(nn_mult=10, grid_sp=3, disp_hw=2),
            Stage1Setting(nn_mult=5, grid_sp=3, disp_hw=2),
            Stage1Setting(nn_mult=10, grid_sp=2, disp_hw=1)]


def stage2_settings():
    from convexadam_torch.selfconfig.settings import Stage2Setting

    return [Stage2Setting(grid_sp_adam=2, avg_n=2, lambda_weight=1.0),
            Stage2Setting(grid_sp_adam=3, avg_n=1, lambda_weight=0.6)]


def paired_case(seed: int = 7):
    """Smooth random volumes rolled by a known shift, ragged keypoint
    counts."""
    rng = np.random.default_rng(seed)
    shape = (PAIRED_N,) * 3
    vols, movs, kfs, kms = [], [], [], []
    for nk in PAIRED_KPTS:
        v = uniform_filter(rng.standard_normal(shape).astype(np.float32), 2) * 100
        vols.append(v)
        movs.append(np.roll(v, PAIRED_SHIFT, axis=(0, 1, 2)))
        k = rng.random((nk, 3)).astype(np.float32) * (PAIRED_N - 12) + 6
        kfs.append(k)
        kms.append(k + np.array(PAIRED_SHIFT, np.float32))
    return np.stack(vols), np.stack(movs), kfs, kms


def paired_settings():
    from convexadam_torch.selfconfig.settings import Stage1PairedSetting, Stage2Setting

    return ([Stage1PairedSetting(mind_r=1, mind_d=2, grid_sp=3, disp_hw=2),
             Stage1PairedSetting(mind_r=2, mind_d=1, grid_sp=4, disp_hw=2)],
            [Stage2Setting(grid_sp_adam=2, avg_n=2, lambda_weight=1.0)])


def register_case():
    """Three smooth 24^3 pairs and a small config for the sharded batch."""
    from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

    vols, movs, _, _ = paired_case(seed=3)
    cfg = ConvexAdamConfig(grid_sp=4, disp_hw=2, selected_niter=10, grid_sp_adam=2,
                           dtype="float32")
    return vols, movs, cfg


def sweeps(mesh):
    """Every sweep of the test file on ``mesh`` (None: one process)."""
    from convexadam_torch.selfconfig import engine, paired

    preds, segs = sweep_dataset()
    s1, s2 = stage1_settings(), stage2_settings()
    out = {
        "stage1_device": engine.run_stage1_sweep(
            preds, segs, SWEEP_PAIRS, s1, num_labels=2, hd95_mode="device", device="cpu",
            mesh=mesh, setting_batch=2),
        "stage1_host": engine.run_stage1_sweep(
            preds, segs, SWEEP_PAIRS, s1, num_labels=2, hd95_mode="host", device="cpu",
            mesh=mesh),
        "stage2": engine.run_stage2_sweep(
            preds, segs, SWEEP_PAIRS, s1[0], s2, num_labels=2, hd95_mode="host",
            device="cpu", mesh=mesh),
    }
    vols, movs, kfs, kms = paired_case()
    p1, p2 = paired_settings()
    out["paired1"] = paired.run_stage1_paired_sweep(vols, movs, kfs, kms, p1, device="cpu",
                                                    mesh=mesh)
    out["paired2"] = paired.run_stage2_paired_sweep(vols, movs, kfs, kms, p1[0], p2,
                                                    device="cpu", mesh=mesh)
    return out


def cli_sweep(config_path: str, argv_extra=()) -> None:
    """The sweep CLI's ``convex`` stage over the first :data:`CLI_SETTINGS`
    seeded settings."""
    import convexadam_torch.selfconfig as tsc
    from convexadam_torch.cli import sweep as t_sweep

    full = tsc.stage1_settings
    tsc.stage1_settings = lambda: full()[:CLI_SETTINGS]
    try:
        t_sweep.main(["convex", config_path, "--device", "cpu", *argv_extra])
    finally:
        tsc.stage1_settings = full


def main(out_dir: str, cli_config: str) -> int:
    import convexadam_torch.selfconfig.checkpoint as ckpt
    from convexadam_torch.core.convex import convex_displacement_tp
    from convexadam_torch.parallel.batch import make_mesh, make_sweep_mesh, register_pairs_sharded
    from convexadam_torch.parallel.distributed import init_distributed

    torch.set_num_threads(2)
    rank = int(os.environ["RANK"])
    joined = init_distributed(backend="gloo", timeout_s=60)
    res: dict = {"joined": joined}
    f, m = (torch.from_numpy(a) for a in tp_features())
    for q, metric, passes in TP_CASES:
        res[("tp", q, metric)] = convex_displacement_tp(
            f, m, q, dist.group.WORLD, metric=metric, smooth_passes=passes).numpy()
    vols, movs, cfg = register_case()
    res["sharded"] = register_pairs_sharded(vols, movs, cfg, make_mesh(device="cpu")).numpy()
    # each pair split along H over a (pair 1, space 2) grid; a volume of one
    # 4-row slab unit refused
    space = make_mesh(1, 2, device="cpu")
    res["space"] = register_pairs_sharded(vols, movs, cfg, space, shard_space=True).numpy()
    try:
        register_pairs_sharded(vols[:, :4], movs[:, :4], cfg, space, shard_space=True)
        res["space_refusal"] = None
    except ValueError as e:
        res["space_refusal"] = str(e)
    for grid in GRIDS:
        res[("sweeps", grid)] = sweeps(make_sweep_mesh(*grid, device="cpu"))
    saves = []
    save = ckpt.SweepCheckpointer.save
    ckpt.SweepCheckpointer.save = lambda self, state: (saves.append(sorted(state["completed"])),
                                                       save(self, state))
    cli_sweep(cli_config, ("--mesh", "--setting_batch", "2"))
    ckpt.SweepCheckpointer.save = save
    res["cli_saves"] = saves
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(res, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
