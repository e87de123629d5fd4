"""``cost_box_ms`` on a made-up window: the ``convex.box`` spans' stream time
a case, and nothing from a program whose calls hold no such span."""

from __future__ import annotations

import types

import pytest
from rb.spec import HERE, load_module

read = load_module(HERE / "layer_metrics" / "cost_box_ms.py", "t_cost_box_ms").read


def _span(name, stream_ms):
    return types.SimpleNamespace(name=name, stream_ms=stream_ms)


def _call(box_ms, stream=True):
    spans = []
    for ms in box_ms:
        spans += [_span("sweep.convex", 100.0 if stream else None),
                  _span("convex.cost_volume", 2 * ms if stream else None),
                  _span("convex.box", ms if stream else None)]
    return types.SimpleNamespace(spans=spans, counters={"box_passes.kernel": len(box_ms)})


def test_cost_box_ms_sums_the_box_spans_over_the_cases():
    ctx = types.SimpleNamespace(calls=[(0.0, 1.0, _call([3.0, 4.0])), (1.0, 2.0, _call([5.0]))],
                                cases=3)
    assert read(ctx) == pytest.approx(4.0)


def test_cost_box_ms_reads_nothing_without_the_span_or_its_stream_time():
    old = types.SimpleNamespace(spans=[_span("sweep.convex", 100.0),
                                       _span("convex.cost_volume", 9.0)], counters={})
    assert read(types.SimpleNamespace(calls=[(0.0, 1.0, old)], cases=1)) is None
    bare = types.SimpleNamespace(dice=None, times=[1.0])  # a result with no record
    assert read(types.SimpleNamespace(calls=[(0.0, 1.0, bare)], cases=1)) is None
    cpu = types.SimpleNamespace(calls=[(0.0, 1.0, _call([3.0], stream=False))], cases=1)
    assert read(cpu) is None
