"""A run whose timed path is broken underneath comes out not correct, once
for each fault a sweep cell can have; the unbroken run comes out correct.

Each test skips nothing of a run but the look for a card: the tiny cell
runs on the CPU through :func:`rb.harness.run_cell`, with the program
patched where the fault would lie."""

from __future__ import annotations

import time

import pytest
from conftest import tiny_cell


def _run(root, workload):
    from rb.harness import run_cell

    line, checks = run_cell(tiny_cell(root, workload), 2**31 + 5, 0.0, False, "cpu",
                            time.perf_counter())
    return line, checks


def _half_the_pairs(module, monkeypatch):
    real = module._Fanout

    class Half(real):
        def __init__(self, mesh, n_pairs, setting_batch):
            super().__init__(mesh, n_pairs, setting_batch)
            self.pairs = self.pairs[: max(1, len(self.pairs) // 2)]

    monkeypatch.setattr(module, "_Fanout", Half)


def _semantic_fault(kind, monkeypatch):
    from convexadam_torch.selfconfig import engine

    if kind == "state_unchanged":  # the convex stage hands back the identity
        real = engine.convex_field_semantic
        monkeypatch.setattr(engine, "convex_field_semantic",
                            lambda *a, **k: real(*a, **k).zero_())
    elif kind == "half_the_pairs":
        _half_the_pairs(engine, monkeypatch)
    elif kind == "answer_altered":  # the Dice off by 2% where it is made
        real = engine.evaluate_field_semantic

        def altered(*a, **k):
            d, j, n, s = real(*a, **k)
            return d * 0.98, j, n, s

        monkeypatch.setattr(engine, "evaluate_field_semantic", altered)


def _paired_fault(kind, monkeypatch):
    from convexadam_torch.selfconfig import paired

    if kind == "state_unchanged":
        real = paired.convex_field_mind
        monkeypatch.setattr(paired, "convex_field_mind", lambda *a, **k: real(*a, **k).zero_())
    elif kind == "half_the_pairs":
        _half_the_pairs(paired, monkeypatch)
    elif kind == "answer_altered":  # the TRE off by 2% where it is made
        real = paired._field_metrics
        monkeypatch.setattr(paired, "_field_metrics",
                            lambda *a, **k: real(*a, **k) * paired.torch.tensor(
                                [1.02, 1.0, 1.0, 1.0]))


@pytest.mark.parametrize("workload, rate", [("abdct-sweep1", "scored_pairs_per_s"),
                                            ("nlst-sweep1", "scored_pairs_per_s.card_paced")])
def test_the_unbroken_run_is_correct(tiny_root, workload, rate):
    line, checks = _run(tiny_root, workload)
    assert line["failed"] == 0 and all(c.ok for c in checks), checks
    assert set(line["metrics"]) == {rate, "peak_gb", "setup_s"}
    assert line["metrics"][rate]["value"] > 0


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_pairs", "answer_altered"])
@pytest.mark.parametrize("workload", ["abdct-sweep1", "nlst-sweep1"])
def test_a_broken_run_is_not_correct(tiny_root, workload, kind, monkeypatch):
    (_semantic_fault if workload == "abdct-sweep1" else _paired_fault)(kind, monkeypatch)
    _, checks = _run(tiny_root, workload)
    assert not all(c.ok for c in checks), checks
