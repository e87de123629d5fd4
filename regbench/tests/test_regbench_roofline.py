"""The cost volume's bound against hand counts."""

from __future__ import annotations

import pytest
from rb.roofline import cost_volume_bound_s, cost_volume_work


def test_row_2_shape_of_the_kernel_table():
    # 12 channels on 32^3, K = 9: n = 32768, K^3 = 729
    # bytes 4 (2*12*32768 + 729*32768) = 98,697,216; ops 3*729*32768*12
    assert cost_volume_work(12, (32, 32, 32), 4) == (98_697_216, 859_963_392)
    # memory-bound: 98,697,216 / 3.35e12 s = 0.02946 ms (PERF.md's 0.0295)
    assert cost_volume_bound_s(12, (32, 32, 32), 4) == pytest.approx(2.9461855e-5, rel=1e-6)


def test_the_semantic_2_5_class():
    # 14 one-hot channels, grid_sp 2 at 192x160x256: 96x80x128 = 983,040
    # coarse voxels, K = 11, K^3 = 1331; bytes 4 * (28 + 1331) * 983,040,
    # operations 3 * 1331 * 14 * 983,040: compute-bound at 33.5 T/s
    nbytes, ops = cost_volume_work(14, (96, 80, 128), 5)
    assert (nbytes, ops) == (5_343_805_440, 54_953_902_080)
    assert cost_volume_bound_s(14, (96, 80, 128), 5) == pytest.approx(ops / 33.5e12)
    assert ops / 33.5e12 > nbytes / 3.35e12
