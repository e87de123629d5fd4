"""Stage 1 of the semantic self-configuring sweep over the coarse settings
only: the first ``settings.first`` of the reference's seeded stage-1 list
whose grid_sp is one of ``settings.grid_sp``, over every pair of the
configuration.  Everything else, the call and the check, is
``stage1_semantic.py``'s, loaded from beside this file."""

from __future__ import annotations

import pathlib

from rb.settings import SAMPLERS
from rb.spec import load_module

_base = load_module(pathlib.Path(__file__).resolve().parent / "stage1_semantic.py",
                    "regbench_entry_stage1_semantic")
GAPS = _base.GAPS


def coarse_settings(traffic: dict) -> "list[dict]":
    """The first ``first`` of the ``of`` settings the sampler draws at
    ``seed`` whose grid_sp is in ``grid_sp``."""
    spec = traffic["settings"]
    drawn = SAMPLERS[spec["sampler"]](int(spec["of"]), int(spec["seed"]))
    keep = [s for s in drawn if s["grid_sp"] in spec["grid_sp"]]
    return keep[:int(spec["first"])]


class Session(_base.Session):
    """``stage1_semantic.Session`` over the coarse settings."""

    def __init__(self, cell, inputs, device):
        from convexadam_torch.selfconfig.settings import Stage1Setting

        super().__init__(cell, inputs, device)
        self.settings = coarse_settings(cell.traffic)
        self.program_settings = [Stage1Setting(**s) for s in self.settings]
        self.cases_per_call = len(self.settings) * len(self.pairs)
