"""The trace arithmetic on a made-up profile."""

from __future__ import annotations

import types

import pytest
from rb.trace import Trace, gaps, merge, union_seconds


def _trace():
    # window 0..10; kernels overlap on 1..2, a copy inside a kernel
    device = [("cost_volume_kernel<5, false>", 0.0, 2.0, 1),
              ("argmin_kernel", 1.0, 3.0, 2),
              ("memcpy", 1.5, 2.5, 3),
              ("hd95_kernel", 5.0, 6.0, 4),
              ("late_kernel", 9.5, 12.0, 5)]
    ranges = [("regbench.window", 0.0, 10.0), ("regbench.call", 0.0, 10.0),
              ("sweep.convex", 0.0, 0.5), ("sweep.hd95", 4.0, 4.5), ("sweep.fetch", 6.0, 9.0)]
    issued = {1: 0.1, 2: 0.2, 3: 0.3, 4: 4.2, 5: 6.5}
    return Trace(device, ranges, issued)


def test_union_of_overlapping_intervals():
    assert merge([(2, 3), (0, 2), (1, 1.5), (5, 5)]) == [(0, 3)]
    assert union_seconds([(0, 2), (1, 3), (1.5, 2.5), (5, 6)]) == 4.0
    assert gaps([(0, 3), (5, 6)], 0, 10) == [(3, 5), (6, 10)]


def test_busy_idle_and_attribution():
    tr = _trace()
    assert tr.window() == (0.0, 10.0)
    assert tr.busy() == pytest.approx(3.0 + 1.0 + 0.5)  # clipped at the window's end
    by = tr.device_by_range()
    assert by == {"sweep.convex": pytest.approx(5.0), "sweep.hd95": 1.0,
                  "sweep.fetch": pytest.approx(2.5)}
    idle = dict(tr.idle_gaps())
    # 3..5 began with the host between ranges inside the call, 6..9.5 in fetch
    assert idle == {"call outside sweep ranges": pytest.approx(2.0),
                    "sweep.fetch": pytest.approx(3.5)}
    assert tr.device_ops(2)[0] == ["late_kernel", 2.5]


def test_idle_share_reader():
    from rb.spec import HERE, load_module

    read = load_module(HERE / "layer_metrics" / "device_idle_share.py", "t_idle").read
    assert read(types.SimpleNamespace(trace=_trace())) == pytest.approx(55.0)
