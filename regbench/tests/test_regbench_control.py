"""The precision control: the plain reference in bfloat16, put in the
program's place, reads far from the float32 reference where the program
reads close to it; at the cells' own size, on the card, it fails their
limits (the limits are set there, from those readings)."""

from __future__ import annotations

import pytest
import torch
from conftest import ROOT, tiny_cell


@pytest.mark.parametrize("workload", ["abdct-sweep1", "nlst-sweep1"])
def test_the_bfloat16_reference_reads_far_from_the_program(tiny_root, workload):
    """At a size a test can hold, one number reads at least 100 times
    higher for the control than for the program, on each seed; the
    program stays within the cell's limits."""
    from control import readings

    cell = tiny_cell(tiny_root, workload)
    for seed in (2**31 + 21, 2**31 + 22):
        r = readings(cell, seed, torch.device("cpu"), program=True)
        assert any(v > 100 * max(r["program"][k], 1e-12) for k, v in r["control"].items()), r
        assert all(r["program"][k] <= cell.limits[k] for k in r["control"]), r


@pytest.mark.card
@pytest.mark.parametrize("workload", ["abdct-sweep1", "nlst-sweep1"])
def test_the_control_fails_at_the_cells_own_size_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from control import readings

    cell = tiny_cell(ROOT, workload)
    for seed in (2**31 + 31, 2**31 + 32, 2**31 + 33):
        r = readings(cell, seed, torch.device("cuda"), program=False)
        assert any(v > cell.limits[k] for k, v in r["control"].items()), r
