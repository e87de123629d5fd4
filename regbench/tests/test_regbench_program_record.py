"""The readers of the program's own record (``SweepResult.spans`` and
``SweepResult.counters``) on a made-up window, and their silence where a
call returned no record, as an older program's calls do."""

from __future__ import annotations

import types

import pytest
from rb.spec import HERE, load_module


def _reader(name):
    return load_module(HERE / "layer_metrics" / f"{name}.py", f"t_{name}").read


def _span(name, start_s, end_s, stream_ms=None):
    return types.SimpleNamespace(name=name, start_ns=int(start_s * 1e9), end_ns=int(end_s * 1e9),
                                 stream_ms=stream_ms)


def _ctx(*results, cases):
    return types.SimpleNamespace(calls=[(0.0, 1.0, r) for r in results], cases=cases)


def _call(prep_s, coupled_ms, waits, stream=True):
    spans = [_span("sweep.prep", 1.0, 1.0 + prep_s), _span("sweep.prep.upload", 1.0, 1.5)]
    for ms in coupled_ms:
        spans += [_span("sweep.convex", 2.0, 3.0, 100.0 if stream else None),
                  _span("convex.coupled", 2.1, 2.2, ms if stream else None)]
    counters = {f"host_waits.{k}": v for k, v in waits.items()}
    counters["kernel_loads"] = 10**9  # not a wait
    return types.SimpleNamespace(spans=spans, counters=counters)


def test_prep_span_s_is_the_mean_over_calls_of_the_prep_span():
    ctx = _ctx(_call(4.0, [1.0], {"sweep.fetch": 1}), _call(5.0, [1.0], {"sweep.fetch": 1}),
               cases=2)
    assert _reader("prep_span_s")(ctx) == pytest.approx(4.5)


def test_argmin_dev_ms_sums_the_coupled_stream_time_over_the_cases():
    ctx = _ctx(_call(4.0, [30.0, 40.0], {}), _call(4.0, [50.0, 60.0], {}), cases=2)
    assert _reader("argmin_dev_ms")(ctx) == pytest.approx(90.0)


def test_argmin_dev_ms_reads_nothing_without_stream_time():
    ctx = _ctx(_call(4.0, [30.0], {}, stream=False), cases=1)
    assert _reader("argmin_dev_ms")(ctx) is None


def test_host_waits_per_case_sums_the_wait_counters_only():
    ctx = _ctx(_call(4.0, [1.0], {"sweep.fetch": 5, "convex.features": 18}),
               _call(4.0, [1.0], {"sweep.fetch": 5, "convex.features": 18}), cases=4)
    assert _reader("host_waits_per_case")(ctx) == pytest.approx(2 * 23 / 4)


@pytest.mark.parametrize("name", ["prep_span_s", "argmin_dev_ms", "host_waits_per_case"])
def test_a_program_without_a_record_reads_nothing(name):
    old = types.SimpleNamespace(dice=None, times=[1.0])  # a result with no record
    assert _reader(name)(_ctx(old, old, cases=2)) is None
    empty = types.SimpleNamespace(spans=[], counters={})  # tracing was off
    assert _reader(name)(_ctx(empty, cases=1)) is None
