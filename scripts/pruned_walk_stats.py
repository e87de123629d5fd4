#!/usr/bin/env python3
"""Tile counts of the pruned search's walk for other block shapes, on the
host CPU.

Run from the repository root:

    python3 scripts/pruned_walk_stats.py [--against-itself]

On ``chip_smoke.py``'s 13-organ label pair (seed 0, moving = fixed rolled
by the headline shift; with ``--against-itself`` the fixed volume against
itself, as a registered field nearly gives it) it builds every pruned search
of each label bucket as the HD95 engine does and walks them with query
blocks of 128 and 32 points, 128-point target tiles, and 1, 2, 4 or 8 tiles
a step before the bound is updated (the stopping rule of
``convexadam_torch/kernels/edt.py``).  Per bucket and shape it prints the
tiles visited, the cells they hold, the query blocks with a meaningful
query, the most tiles and steps one block takes, and each search's tiles
and most tiles (four searches a label: inner_m -> inner_f, inner_f ->
inner_m, inner_m -> outer_f, inner_f -> outer_m).  These are properties
of the data and the walk, not device figures.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def walk(torch, q, t, lo, hi, nt, qb, tb, step):
    """Tiles and steps of each query block of one search."""
    from convexadam_torch.kernels.edt import ACC_INIT, COORD_PAD

    gi, gj = q.shape[1] // qb, t.shape[1] // tb
    big = 2.0 * COORD_PAD

    def boxes(p):
        real = p[0:1] < COORD_PAD
        return torch.where(real, p, big).amin(2), torch.where(real, p, -big).amax(2)

    qp, tp = q.reshape(3, gi, qb), t.reshape(3, gj, tb)
    qmn, qmx = boxes(qp)
    tmn, tmx = boxes(tp)
    gap = torch.clamp(torch.maximum(qmn[:, :, None] - tmx[:, None, :],
                                    tmn[:, None, :] - qmx[:, :, None]), min=0.0)
    dmin = (gap[0] * gap[0] + gap[1] * gap[1]) + gap[2] * gap[2]
    dmin = torch.where((torch.arange(gj) * tb >= nt)[None, :], 3.0e38, dmin)
    dsort, order = torch.sort(dmin, dim=1, stable=True)
    start = torch.arange(gi) * qb
    idx = start[:, None] + torch.arange(qb)
    meaningful = (idx >= lo) & (idx < hi)
    active = meaningful.any(1)
    live_blocks = int(active.sum())
    t_live = (torch.arange(gj * tb) < nt).reshape(gj, tb)
    rows = qp.permute(1, 2, 0)
    cur = torch.full((gi, qb), ACC_INIT)
    bound = torch.full((gi,), ACC_INIT)
    tiles = torch.zeros(gi, dtype=torch.long)
    steps = torch.zeros(gi, dtype=torch.long)
    for j0 in range(0, gj, step):
        if not bool(active.any()):
            break
        steps += active
        every = active.clone()
        for g in range(min(step, gj - j0)):
            inc = active & (dsort[:, j0 + g] <= bound)
            jj = order[:, j0 + g]
            d = ((rows[:, :, None, :] - tp[:, jj].permute(1, 2, 0)[:, None]) ** 2).sum(-1)
            d = torch.where(t_live[jj][:, None, :], d, torch.inf)
            cur = torch.where(inc[:, None], torch.minimum(cur, d.amin(2)), cur)
            tiles += inc
            every &= inc
        active = every & (j0 + step < gj)
        bound = torch.where(meaningful, cur, -1.0).amax(1)
    return tiles, steps, live_blocks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against-itself", action="store_true")
    args = ap.parse_args()

    import torch

    from chip_smoke import L2R_LABELS, l2r_label_pair
    from convexadam_torch.core.edt import (
        label_buffers,
        pruned_searches,
        suggest_hd95_caps,
        surface_lists,
    )

    seg_f, seg_m = l2r_label_pair()
    if args.against_itself:
        seg_m = seg_f
    groups, gcap = suggest_hd95_caps(seg_f, seg_m, L2R_LABELS)
    caps = [0] * (L2R_LABELS + 1)
    for labs, k in groups:
        for lab in labs:
            caps[lab] = k
    caps = tuple(caps)
    pre = surface_lists(torch.from_numpy(seg_f), torch.from_numpy(seg_m), L2R_LABELS, gcap)
    bufs = label_buffers(pre, L2R_LABELS, caps)
    for labs, K in groups:
        sources, searches, lo, hi, nt = pruned_searches(bufs, caps, K, labs)
        for qb in (128, 32):
            for step in (1, 2, 4, 8):
                total = most = most_steps = live = 0
                per_search = []
                for s, (qs, qo, ts, to) in enumerate(searches):
                    tiles, steps, n = walk(torch, sources[qs][:, qo:qo + K],
                                           sources[ts][:, to:to + K], int(lo[s]), int(hi[s]),
                                           int(nt[s]), qb, 128, step)
                    per_search.append([int(tiles.sum()), int(tiles.max())])
                    total += int(tiles.sum())
                    most = max(most, int(tiles.max()))
                    most_steps = max(most_steps, int(steps.max()))
                    live += n
                print(json.dumps({"K": K, "labels": len(labs), "query_block": qb, "step": step,
                                  "tiles": total, "cells": total * qb * 128,
                                  "live_blocks": live, "most_tiles": most,
                                  "most_steps": most_steps,
                                  "tiles_and_most_per_search": per_search}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
