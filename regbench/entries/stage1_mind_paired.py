"""Stage 1 of the paired MIND sweep (lung CT, keypoint TRE): every setting
of the mix over every pair of the configuration, through the program's
``run_stage1_paired_sweep``, and the check of what it scored.

The sweep returns each setting's scores as means over the pairs, so the
check recomputes with the plain reference a sample of settings drawn from
the seed, the costliest always in it, over every pair, and holds each call's
mean and robust-30 TRE, SDlogJ and negative-Jacobian share of those
settings to it; it also recomputes each call's ranks and winner from its
per-setting scores.
"""

from __future__ import annotations

import numpy as np
import torch

from rb.harness import Check
from rb.settings import settings_of
from reference.convex import convex_field, pool
from reference.features import mind_ssc
from reference.scores import (
    jacobian_stats,
    keypoint_tre,
    rank_product,
    robust30_keypoints,
    sort_rank,
)

#: the numbers compared per sampled setting, each the largest over the
#: sample and the calls; the negative-Jacobian share is not among them: no
#: run of the program or of the precision control has read a fold here
GAPS = ("tre_gap", "sdlogj_gap")


def reference_setting(inputs: dict, setting: dict, dtype, device) -> dict:
    """The reference's scores of one setting, means over the pairs: TRE
    and robust-30 TRE (mm), SDlogJ and the negative-Jacobian share."""
    rows = []
    r, d, g, q = setting["mind_r"], setting["mind_d"], setting["grid_sp"], setting["disp_hw"]
    for i in range(len(inputs["imgs_fixed"])):
        with torch.no_grad():
            f = torch.from_numpy(inputs["imgs_fixed"][i]).to(device)
            m = torch.from_numpy(inputs["imgs_moving"][i]).to(device)
            fs = pool(mind_ssc(f, r, d, dtype), g, dtype)
            ms = pool(mind_ssc(m, r, d, dtype), g, dtype)
            field = convex_field(fs, ms, q, g, f.shape)
            del fs, ms
            kf_np, km_np = inputs["kpts_fixed"][i], inputs["kpts_moving"][i]
            kf, km = (torch.from_numpy(np.asarray(k, np.float32)).to(device)
                      for k in (kf_np, km_np))
            tre = keypoint_tre(field, kf, km, inputs["spacing"])
            rob = robust30_keypoints(np.asarray(kf_np), np.asarray(km_np))
            sdlogj, neg = jacobian_stats(field)
        rows.append((tre.mean(), tre[rob].mean(), sdlogj, neg))
    a = np.asarray(rows, np.float64).mean(0)
    return {"tre": a[:2], "jstd": a[2:]}


def setting_gaps(got: dict, reference: dict) -> dict:
    """The largest gaps over the sampled settings between the scores
    ``got`` and the reference's: mean and robust-30 TRE (mm) and SDlogJ."""
    out = dict.fromkeys(GAPS, 0.0)
    for s, ref in reference.items():
        c = got[s]
        out["tre_gap"] = max(out["tre_gap"], float(np.max(np.abs(c["tre"] - ref["tre"]))))
        out["sdlogj_gap"] = max(out["sdlogj_gap"], abs(float(c["jstd"][0]) - ref["jstd"][0]))
    return out


class Session:
    """The program's paired sweep over this cell's settings and pairs."""

    def __init__(self, cell, inputs: dict, device: torch.device):
        from convexadam_torch.selfconfig.settings import Stage1PairedSetting

        self.cell, self.inputs, self.device = cell, inputs, device
        self.settings = settings_of(cell.traffic)
        self.program_settings = [Stage1PairedSetting(**s) for s in self.settings]
        self.n_pairs = len(inputs["imgs_fixed"])
        self.cases_per_call = len(self.settings) * self.n_pairs

    def call(self, warm: bool = False):
        """One call of the program's sweep (``warm``: over the first pair)."""
        from convexadam_torch.selfconfig.paired import run_stage1_paired_sweep

        n = 1 if warm else self.n_pairs
        x = self.inputs
        return run_stage1_paired_sweep(x["imgs_fixed"][:n], x["imgs_moving"][:n],
                                       x["kpts_fixed"][:n], x["kpts_moving"][:n],
                                       self.program_settings, spacing=x["spacing"],
                                       device=self.device)

    def cost_volumes(self) -> "list[tuple[int, tuple, int]]":
        """(channels, coarse grid, disp_hw) of each cost volume a call
        computes: two a (setting, pair)."""
        shape = self.inputs["imgs_fixed"].shape[1:]
        return [(12, tuple(n // s["grid_sp"] for n in shape), s["disp_hw"])
                for s in self.settings for _ in range(self.n_pairs) for _ in range(2)]

    def failed(self, results) -> int:
        """Cases of the window in settings whose scores are not numbers."""
        bad = 0
        for r in results:
            ok = np.isfinite(r.dice).all(1) & np.isfinite(r.jstd).all(1)
            bad += int(ok.size - ok.sum()) * self.n_pairs
        return bad

    def sample(self, seed: int) -> "list[int]":
        """The settings the reference recomputes: the costliest and the
        rest drawn from the seed."""
        n = int(self.cell.traffic["check"]["settings"])
        shape = self.inputs["imgs_fixed"].shape[1:]
        cost = [(2 * s["disp_hw"] + 1) ** 3 * int(np.prod([k // s["grid_sp"] for k in shape]))
                for s in self.settings]
        first = int(np.argmax(cost))
        rest = [s for s in range(len(self.settings)) if s != first]
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
        return [first] + [rest[int(i)] for i in sorted(pick)]

    def reference(self, seed: int, dtype=torch.float32, keys=None) -> dict:
        """The reference's scores of the sampled settings (or of ``keys``)."""
        keys = self.sample(seed) if keys is None else keys
        return {s: reference_setting(self.inputs, self.settings[s], dtype, self.device)
                for s in keys}

    gaps = staticmethod(setting_gaps)

    def judge(self, results, seed: int, reference=None) -> "list[Check]":
        """The checks of the window's results (``reference``: the
        reference's scores, when already made)."""
        lim = self.cell.limits
        reference = self.reference(seed) if reference is None else reference
        S = len(self.settings)
        missing, gaps, winner_miss, rank_gap = 0, dict.fromkeys(GAPS, 0.0), 0, 0.0
        for r in results:
            if r.dice.shape != (S, 2) or not (np.isfinite(r.dice).all()
                                              and np.isfinite(r.jstd).all()):
                missing += 1
                continue
            got = {s: {"tre": r.dice[s], "jstd": r.jstd[s]} for s in reference}
            for k, v in setting_gaps(got, reference).items():
                gaps[k] = max(gaps[k], v)
            rank = rank_product([sort_rank(r.dice[:, 0]), sort_rank(r.dice[:, 1]),
                                 sort_rank(r.jstd[:, 0])])
            rank_gap = max(rank_gap, float(np.max(np.abs(r.rank - rank))))
            winner_miss += int(r.best != int(np.argmax(rank)))
        checks = [Check("missing_calls", float(missing), 0.0)]
        checks += [Check(k, float(v), float(lim[k])) for k, v in gaps.items()]
        checks += [Check("rank_gap", rank_gap, 0.0), Check("winner_miss", float(winner_miss), 0.0)]
        return checks
