"""Learn2Reg 2021 task 1 validated over labelled MR/CT pairs: one call of
the program's ``task1_validation`` over every pair of the configuration
(register, TPS-densify, map to the original grid, score), and the check of
what it produced.

The check recomputes, with the plain reference, the whole recipe for a
sample of the pairs drawn from the seed, and holds every call's
original-space fields of those pairs to it by their mean distance.  It
also scores each call's own densified fields of those pairs with the
reference's Dice and SDlogJ, maps them to the original grid with the
reference's map, and holds the call's scores and original-space fields to
those.  The scores of the reference's own fields are not compared, nor the
share of values far from them: the Adam stage's unit steps carry float32
rounding on to whole voxels here and there, so the program strays from
them in those about as far as a bfloat16 computation, or on some seeds
nearly as far (PERF.md section 2).
"""

from __future__ import annotations

import numpy as np
import torch

from rb.harness import Check
from reference.scores import dice, jacobian_stats, warp_labels
from reference.task1 import field_to_original, task1_pair

#: the number compared against the reference's recipe per sampled pair,
#: the largest over the sample and the calls
GAPS = ("orig_gap",)
#: the numbers compared against the reference's scores and map of the
#: call's own densified fields: per-organ Dice, SDlogJ, and the mean
#: distance of the original-space field (voxels); not HD95, which the
#: bfloat16 control leaves where it was on every seed (surface distances
#: move by whole voxels; PERF.md section 2), nor the negative-Jacobian
#: share: the recipe's smoothed fields do not fold
OWN_GAPS = ("dice_gap", "sdlogj_gap", "map_gap")
#: directions of the convex stage with inverse consistency
DIRECTIONS = 2


def own_answers(inputs: dict, i: int, densified: np.ndarray, device, dtype=torch.float32) -> dict:
    """The reference's per-organ Dice of pair ``i`` under the densified
    field (H, W, D, 3), its SDlogJ, and its half-resolution
    original-space map (a host array), the field rounded to ``dtype``
    first (bfloat16: the control of the own-field check)."""
    on = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    dense = on(densified).to(dtype).float().permute(3, 0, 1, 2)
    L, sp = inputs["num_labels"], inputs["spacing"]
    sf, sm = on(inputs["segs_fixed"][i]), on(inputs["segs_moving"][i])
    with torch.no_grad():
        warped = warp_labels(sm, dense)
        out = {"dice": dice(sf, warped, L), "sdlogj": jacobian_stats(dense)[0],
               "orig": field_to_original(dense, sp, sp, inputs["original"]).cpu().numpy()}
    del dense, warped
    return out


def own_gaps(got: dict, ref: dict) -> dict:
    """The own-field numbers of one pair: the largest per-organ |difference|
    of Dice, that of SDlogJ, and the mean |difference| of the
    original-space field (voxels), between the answers ``got`` and
    ``ref``."""
    out = {k + "_gap": float(np.max(np.abs(np.asarray(got[k], np.float64) - ref[k])))
           for k in ("dice", "sdlogj")}
    out["map_gap"] = _mean_gap(got["orig"], ref["orig"])
    return out


def reference_pair(inputs: dict, config: dict, i: int, dtype, device) -> dict:
    """The reference's recipe for pair ``i``: the half-resolution
    original-space field (a host array)."""
    on = (lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device))
    f, m = on(inputs["imgs_fixed"][i]), on(inputs["imgs_moving"][i])
    dense = task1_pair(f, m, inputs["masks"][i], config, dtype)
    del f, m
    with torch.no_grad():
        sp = inputs["spacing"]
        return {"orig": field_to_original(dense, sp, sp, inputs["original"]).cpu().numpy()}


def _mean_gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).mean())


def pair_gaps(got: dict, reference: dict) -> dict:
    """The largest over the sampled pairs of the mean |difference|
    (original voxels) between the original-space fields ``got`` and the
    reference recipe's."""
    return {"orig_gap": max(_mean_gap(got[i]["orig"], ref["orig"])
                            for i, ref in reference.items())}


class Session:
    """The program's task-1 validation over this cell's pairs."""

    def __init__(self, cell, inputs: dict, device: torch.device):
        # imported here, so that a program without the entry fails at once
        from convexadam_torch.pipeline.challenges import Task1CaseMeta, task1_validation
        from convexadam_torch.pipeline.convex_adam import ConvexAdamConfig

        self.cell, self.inputs, self.device = cell, inputs, device
        c = cell.config
        self.run = task1_validation
        self.cfg = ConvexAdamConfig(
            mind_r=c["mind_r"], mind_d=c["mind_d"], grid_sp=c["grid_sp"], disp_hw=c["disp_hw"],
            ic=c["ic"], grid_sp_adam=c["grid_sp_adam"], selected_niter=c["adam_iters"],
            lambda_weight=c["lambda_weight"], dtype=c["precision"])
        self.meta = Task1CaseMeta(**inputs["original"])
        self.n_pairs = len(inputs["imgs_fixed"])
        self.cases_per_call = self.n_pairs

    def call(self, warm: bool = False):
        """One call of the program's validation (``warm``: the first pair)."""
        n = 1 if warm else self.n_pairs
        x = self.inputs
        return self.run(x["imgs_fixed"][:n], x["imgs_moving"][:n], x["masks"][:n],
                        x["segs_fixed"][:n], x["segs_moving"][:n], [self.meta] * n,
                        x["num_labels"], cfg=self.cfg, device=self.device)

    def _coarse(self):
        return tuple(n // self.cell.config["grid_sp"] for n in self.inputs["imgs_fixed"].shape[1:])

    def cost_volumes(self) -> "list[tuple[int, tuple, int]]":
        """(channels, coarse grid, disp_hw) of each cost volume a call
        computes: two a pair (12 MIND-SSC channels)."""
        return [(12, self._coarse(), self.cell.config["disp_hw"])] * (DIRECTIONS * self.n_pairs)

    def fold_class(self) -> "tuple[int, int]":
        """(candidates, coarse voxels) of every launch of the coupled
        argmin's fold: one class in this cell."""
        return (2 * self.cell.config["disp_hw"] + 1) ** 3, int(np.prod(self._coarse()))

    @staticmethod
    def _answers(res, i: int) -> dict:
        return {**res.scores[i], "orig": res.fields[i]}

    def own_gaps(self, res, pairs) -> dict:
        """The largest gaps over ``pairs`` between the call's per-organ
        Dice, its SDlogJ and its original-space field and the
        reference's scores and map of its densified fields."""
        out = dict.fromkeys(OWN_GAPS, 0.0)
        for i in pairs:
            ref = own_answers(self.inputs, i, res.densified[i], self.device)
            for k, v in own_gaps(self._answers(res, i), ref).items():
                out[k] = max(out[k], v)
        return out

    def own_control(self, res, pairs) -> dict:
        """The control of :meth:`own_gaps`: the smallest gaps over
        ``pairs`` between the reference's answers under the call's
        densified fields rounded to bfloat16 and under the fields as
        they are."""
        out = dict.fromkeys(OWN_GAPS, float("inf"))
        for i in pairs:
            low, ref = (own_answers(self.inputs, i, res.densified[i], self.device, dt)
                        for dt in (torch.bfloat16, torch.float32))
            for k, v in own_gaps(low, ref).items():
                out[k] = min(out[k], v)
        return out

    def failed(self, results) -> int:
        """Pairs of the window with no score, or a score or a field that is
        not a number."""
        bad = 0
        for r in results:
            bad += self.n_pairs - len(r.scores)
            for i in range(len(r.scores)):
                a = self._answers(r, i)
                ok = all(np.isfinite(a[k]).all() for k in ("dice", "hd95", "sdlogj", "orig"))
                bad += int(not ok)
        return bad

    def sample(self, seed: int) -> "list[int]":
        """The pairs the reference recomputes, drawn from the seed."""
        n = min(int(self.cell.traffic["check"]["cases"]), self.n_pairs)
        rng = np.random.default_rng(seed)
        return sorted(int(i) for i in rng.choice(self.n_pairs, size=n, replace=False))

    def reference(self, seed: int, dtype=torch.float32, keys=None) -> dict:
        """The reference's answers for the sampled pairs (or ``keys``)."""
        keys = self.sample(seed) if keys is None else keys
        return {i: reference_pair(self.inputs, self.cell.config, i, dtype, self.device)
                for i in keys}

    gaps = staticmethod(pair_gaps)

    def judge(self, results, seed: int, reference=None) -> "list[Check]":
        """The checks of the window's results (``reference``: the
        reference's answers, when already made)."""
        lim = self.cell.limits
        reference = self.reference(seed) if reference is None else reference
        L = self.inputs["num_labels"]
        missing, gaps = 0, dict.fromkeys(OWN_GAPS + GAPS, 0.0)
        for r in results:
            if len(r.scores) != self.n_pairs or len(r.densified) != self.n_pairs or any(
                    np.shape(s.get("dice")) != (L,) for s in r.scores):
                missing += 1
                continue
            got = {i: self._answers(r, i) for i in reference}
            for k, v in {**self.own_gaps(r, reference), **pair_gaps(got, reference)}.items():
                gaps[k] = max(gaps[k], v)
        checks = [Check("missing_calls", float(missing), 0.0)]
        checks += [Check(k, float(v), float(lim[k])) for k, v in gaps.items()]
        return checks
