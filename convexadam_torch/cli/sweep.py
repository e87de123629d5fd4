"""CLI: self-configuring hyperparameter sweeps with the reference's JSON
config contract.

Counterpart of ``convexadam_tpu/cli/sweep.py``, with the same flags, plus
``--device``; mirrors convex_run_withconfig.py /
adam_run_withconfig_shiftSpline.py / infer_convexadam.py.  Config keys
(convex_run_withconfig.py:46-58): ``topk`` (case ids), ``topk_pair`` (index
pairs), ``HWD`` (volume shape), ``f_predict`` / ``f_gt`` (printf-style
paths of predicted / ground-truth label volumes), ``num_labels``,
``output`` (metrics file).

``--mesh`` joins the process group that ``torch.distributed``'s environment
describes (``parallel.distributed.init_distributed``: a no-op for one
process; ``torchrun`` with NCCL, one rank a card, for several) and spreads
the sweep's (setting, pair) cells over a (setting, pair) grid of its ranks
(``parallel.batch.make_sweep_mesh``); every rank computes the same result
and rank 0 writes the files and prints.  ``--setting_batch`` is the number of
settings a batch holds (spread along the grid's setting axis; by default one
per rank along it); the metrics checkpoint is written after every batch.
``infer`` runs on one device either way.  Metrics checkpoints are ``.npz``
files, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _load_data(config):
    from convexadam_torch.geometry.io import load_volume_nib_order

    H, W, D = config["HWD"]
    preds, segs = [], []
    for k in config["topk"]:
        p, _ = load_volume_nib_order(config["f_predict"] % k)
        g, _ = load_volume_nib_order(config["f_gt"] % k)
        preds.append(np.asarray(p[:H, :W, :D], np.int32))
        segs.append(np.asarray(g[:H, :W, :D], np.int32))
    return np.stack(preds), np.stack(segs)


def main(argv=None):
    parser = argparse.ArgumentParser(description="self-configuring sweeps")
    parser.add_argument("stage", choices=["convex", "adam", "infer"])
    parser.add_argument("configfile")
    parser.add_argument("--convex_s", type=int, default=None,
                        help="chosen stage-1 setting index (stages adam/infer)")
    parser.add_argument("--adam_s1", type=int, default=None)
    parser.add_argument("--adam_s2", type=int, default=None)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument(
        "--mesh", action="store_true",
        help="fan the sweep out over the ranks of the torch.distributed process group "
        "on a (setting, pair) grid",
    )
    parser.add_argument(
        "--setting_batch", type=int, default=None,
        help="settings per batch, spread over the grid's setting axis and checkpointed "
        "together (default: the setting axis's ranks)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the sweep-state checkpoint (skips completed settings)",
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ('cuda' or 'cpu')")
    args = parser.parse_args(argv)

    with open(args.configfile) as f:
        config = json.load(f)

    from convexadam_torch.selfconfig import (
        decode_adam_variant,
        run_stage1_sweep,
        run_stage2_sweep,
        stage1_settings,
        stage2_settings,
    )

    if args.stage == "infer":
        # rerun the chosen settings on the test pairs and save the fields
        if args.convex_s is None or args.adam_s1 is None:
            parser.error("infer needs --convex_s and --adam_s1")
        from convexadam_torch.selfconfig.infer import run_inference

        run_inference(config, convex_s=args.convex_s, adam_s1=args.adam_s1,
                      adam_s2=args.adam_s2 or 0, verbose=args.verbose, device=args.device)
        return 0

    num_labels = config["num_labels"] - 1
    pairs = [tuple(p) for p in config["topk_pair"]]
    preds, segs = _load_data(config)

    mesh = None
    if args.mesh:
        from convexadam_torch.parallel.batch import make_sweep_mesh
        from convexadam_torch.parallel.distributed import init_distributed

        init_distributed()
        mesh = make_sweep_mesh(device=args.device)
    fan = dict(mesh=mesh, setting_batch=args.setting_batch)
    # every rank computes the result; rank 0 writes it and prints
    lead = mesh is None or mesh.rank == 0

    if args.stage == "convex":
        settings = stage1_settings()
        res = run_stage1_sweep(
            preds, segs, pairs, settings, num_labels, verbose=args.verbose,
            checkpoint_path=config["output"], resume=args.resume, device=args.device, **fan,
        )
        if lead:
            np.savez(
                config["output"],
                dice=res.dice, jstd=res.jstd, hd95=res.hd95, times=res.times, rank=res.rank,
            )
            print(f"best convex setting: s={res.best} {settings[res.best]}")
            print(
                f"dice {res.dice[res.best,0]:.4f}/{res.dice[res.best,1]:.4f} "
                f"jstd {res.jstd[res.best,0]:.4f}"
            )
        # the console-script wrapper sys.exit()s this return value: the best
        # index is printed and saved, not returned as an exit code
        return 0

    if args.convex_s is None:
        parser.error("adam needs --convex_s")
    convex = stage1_settings()[args.convex_s]
    adam_settings = stage2_settings()
    out = config.get("output_adam", config["output"])
    res = run_stage2_sweep(
        preds, segs, pairs, convex, adam_settings, num_labels, verbose=args.verbose,
        checkpoint_path=out, resume=args.resume, device=args.device, **fan,
    )
    if lead:
        np.savez(out, dice=res.dice, jstd=res.jstd, hd95=res.hd95, rank=res.rank)
        s1, s2 = res.best // 16, res.best % 16
        iters, kks = decode_adam_variant(s2)
        print(
            f"best adam setting: s1={s1} s2={s2} {adam_settings[s1]} "
            f"iters={iters} extra_smooth={kks}"
        )
        print(f"dice {res.dice[res.best,0]:.4f}/{res.dice[res.best,1]:.4f}")
    return 0


if __name__ == "__main__":
    main()
