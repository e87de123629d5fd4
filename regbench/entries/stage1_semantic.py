"""Stage 1 of the semantic self-configuring sweep: every setting of the
mix over every pair of the configuration, through the program's
``run_stage1_sweep``, and the check of what it scored.

The check recomputes, with the plain reference, a sample of the window's
(setting, pair) cases drawn from the seed, the costliest setting always in
it, and holds each call's per-case Dice, HD95, SDlogJ and negative-Jacobian
share to it; it also recomputes from each call's per-case scores its
per-setting means, its ranks and its winner.
"""

from __future__ import annotations

import numpy as np
import torch

from rb.harness import Check
from rb.settings import settings_of
from reference.convex import convex_field, pool
from reference.features import onehot_pair
from reference.scores import dice, hd95, jacobian_stats, rank_product, sort_rank, warp_labels


def _coarse(shape, g: int):
    return tuple(n // g for n in shape)


def reference_case(inputs: dict, setting: dict, pair, dtype, device) -> dict:
    """The reference's scores of one (setting, pair): per-label Dice,
    SDlogJ, negative-Jacobian share and label-mean HD95."""
    L = inputs["num_labels"]
    f, m = pair
    on = (lambda a: torch.from_numpy(a).to(device))
    pf, pm = on(inputs["preds"][f]), on(inputs["preds"][m])
    g, q = setting["grid_sp"], setting["disp_hw"]
    with torch.no_grad():
        ff, fm = onehot_pair(pf, pm, L + 1, float(setting["nn_mult"]), dtype)
        fs, ms = pool(ff, g, dtype), pool(fm, g, dtype)
        del ff, fm
        field = convex_field(fs, ms, q, g, pf.shape)
        del fs, ms
        sf, sm = on(inputs["segs"][f]), on(inputs["segs"][m])
        warped = warp_labels(sm, field)
        sdlogj, neg = jacobian_stats(field)
        return {"dice": dice(sf, warped, L), "sdlogj": sdlogj, "neg_jac_frac": neg,
                "hd95": float(np.mean(hd95(sf, warped, L)))}


def robust30_labels(segs: np.ndarray, pairs, num_labels: int) -> "list[np.ndarray]":
    """Per pair the 30% labels of lowest Dice before registration, Dice in
    float32 as counts over the voxel count."""
    out = []
    for f, m in pairs:
        a, b = segs[f].ravel(), segs[m].ravel()
        n = np.float32(a.size)
        cnt = (lambda x: np.bincount(x, minlength=num_labels + 1)[1:num_labels + 1])
        inter = cnt(np.where(a == b, a, 0)).astype(np.float32) / n
        ca, cb = cnt(a).astype(np.float32) / n, cnt(b).astype(np.float32) / n
        d = np.float32(2.0) * inter / (np.float32(1e-8) + ca + cb)
        out.append(np.argsort(d)[:max(1, int((num_labels + 1) * 0.3))])
    return out


def aggregates(cases: dict, robust: list):
    """Per-setting means and the rank product of the per-case scores, as
    convex_run_withconfig.py:155-172 aggregates them."""
    d = cases["dice"]  # (S, P, L)
    S, P = d.shape[:2]
    dice_m = np.zeros((S, 2))
    jstd = np.zeros((S, 2))
    hd = np.zeros(S)
    for s in range(S):
        dice_m[s, 0] = d[s].mean()
        dice_m[s, 1] = np.mean([d[s][i, robust[i]].mean() for i in range(P)])
        jstd[s, 0] = cases["sdlogj"][s].mean()
        jstd[s, 1] = cases["neg_jac_frac"][s].mean()
        hd[s] = cases["hd95"][s].mean()
    ranks = [sort_rank(-dice_m[:, 0]), sort_rank(-dice_m[:, 1]), sort_rank(hd),
             sort_rank(jstd[:, 0])]
    return dice_m, jstd, hd, rank_product(ranks)


CASE_KEYS = ("dice", "sdlogj", "neg_jac_frac", "hd95")
#: the numbers compared per case, each the largest over the sample and calls
GAPS = ("dice_gap", "hd95_gap", "sdlogj_gap")


def case_gaps(got: dict, reference: dict) -> dict:
    """The largest gaps over the sampled cases between the scores ``got``
    and the reference's: per-label Dice, label-mean HD95 (voxels) and
    SDlogJ.  The negative-Jacobian share is not compared: stage-1 fields
    seldom fold, and the precision control reads no gap on it for most
    seeds (PERF.md §2), so no limit could tell the two apart."""
    out = dict.fromkeys(GAPS, 0.0)
    for key, ref in reference.items():
        c = got[key]
        out["dice_gap"] = max(out["dice_gap"], float(np.max(np.abs(c["dice"] - ref["dice"]))))
        out["hd95_gap"] = max(out["hd95_gap"], abs(float(c["hd95"]) - ref["hd95"]))
        out["sdlogj_gap"] = max(out["sdlogj_gap"], abs(float(c["sdlogj"]) - ref["sdlogj"]))
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12))) if a.size else 0.0


class Session:
    """The program's sweep over this cell's settings and pairs."""

    def __init__(self, cell, inputs: dict, device: torch.device):
        from convexadam_torch.selfconfig.settings import Stage1Setting

        self.cell, self.inputs, self.device = cell, inputs, device
        self.settings = settings_of(cell.traffic)
        self.program_settings = [Stage1Setting(**s) for s in self.settings]
        self.pairs = [tuple(p) for p in inputs["pairs"]]
        self.cases_per_call = len(self.settings) * len(self.pairs)

    def call(self, warm: bool = False):
        """One call of the program's sweep (``warm``: over the first pair)."""
        from convexadam_torch.selfconfig.engine import run_stage1_sweep

        pairs = self.pairs[:1] if warm else self.pairs
        return run_stage1_sweep(self.inputs["preds"], self.inputs["segs"], pairs,
                                self.program_settings, num_labels=self.inputs["num_labels"],
                                checkpoint_path=None, device=self.device)

    def cost_volumes(self) -> "list[tuple[int, tuple, int]]":
        """(channels, coarse grid, disp_hw) of each cost volume a call
        computes: two a (setting, pair)."""
        C = self.inputs["num_labels"] + 1
        shape = self.inputs["segs"].shape[1:]
        return [(C, _coarse(shape, s["grid_sp"]), s["disp_hw"])
                for s in self.settings for _ in self.pairs for _ in range(2)]

    def failed(self, results) -> int:
        """Cases of the window with no score, or a score that is not a
        number."""
        bad = 0
        for r in results:
            c = r.cases
            ok = (np.isfinite(c["dice"]).all(-1) & np.isfinite(c["sdlogj"])
                  & np.isfinite(c["neg_jac_frac"]) & np.isfinite(c["hd95"]))
            bad += int(ok.size - ok.sum())
        return bad

    def sample(self, seed: int) -> "list[tuple[int, int]]":
        """The (setting, pair) cases the reference recomputes: one of the
        costliest setting and the rest drawn from the seed."""
        n = int(self.cell.traffic["check"]["cases"])
        shape = self.inputs["segs"].shape[1:]
        cost = [(2 * s["disp_hw"] + 1) ** 3 * int(np.prod(_coarse(shape, s["grid_sp"])))
                for s in self.settings]
        rng = np.random.default_rng(seed)
        S, P = len(self.settings), len(self.pairs)
        first = (int(np.argmax(cost)), int(rng.integers(P)))
        rest = [c for c in ((s, p) for s in range(S) for p in range(P)) if c != first]
        pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
        return [first] + [rest[int(i)] for i in sorted(pick)]

    def reference(self, seed: int, dtype=torch.float32, keys=None) -> dict:
        """The reference's scores of the sampled cases (or of ``keys``)."""
        keys = self.sample(seed) if keys is None else keys
        return {c: reference_case(self.inputs, self.settings[c[0]], self.pairs[c[1]], dtype,
                                  self.device) for c in keys}

    gaps = staticmethod(case_gaps)

    def judge(self, results, seed: int, reference=None) -> "list[Check]":
        """The checks of the window's results (``reference``: the
        reference's scores, when already made)."""
        lim = self.cell.limits
        reference = self.reference(seed) if reference is None else reference
        S, P, L = len(self.settings), len(self.pairs), self.inputs["num_labels"]
        robust = robust30_labels(self.inputs["segs"], self.pairs, L)
        missing, gaps = 0, dict.fromkeys(GAPS, 0.0)
        agg_gap, winner_miss = 0.0, 0
        for r in results:
            c = r.cases
            if c["dice"].shape != (S, P, L) or not np.isfinite(c["dice"]).all():
                missing += 1
                continue
            got = {(s, p): {k: c[k][s, p] for k in CASE_KEYS} for s, p in reference}
            for k, v in case_gaps(got, reference).items():
                gaps[k] = max(gaps[k], v)
            dice_m, jstd, hd, rank = aggregates(c, robust)
            agg_gap = max(agg_gap, _rel(r.dice, dice_m), _rel(r.jstd, jstd), _rel(r.hd95, hd),
                          _rel(r.rank, rank))
            winner_miss += int(r.best != int(np.argmax(rank)))
        checks = [Check("missing_calls", float(missing), 0.0)]
        checks += [Check(k, float(v), float(lim[k])) for k, v in gaps.items()]
        checks += [Check("aggregate_rel", agg_gap, 0.0),
                   Check("winner_miss", float(winner_miss), 0.0)]
        return checks
