"""One run of one cell: inputs from the seed, a warm-up call, the measured
window of whole calls, the per-layer readings of a traced run, and the
check of what the window produced against the plain reference.

The window starts after a warm-up call of the same settings over the first
pair only (every kernel loaded and built, the allocator grown to the
largest class) and ends at the first call boundary at or after
``seconds``; each call ends in a synchronisation, so the window's seconds
hold all the card's work.  Each call runs the program's own sweep entry
with no checkpoint: its per-call preparation is the users' too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
import types

import torch

from rb import trace as tracing
from rb.spec import quantity


@dataclasses.dataclass
class Check:
    """A number compared with its limit: correct while ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Card:
    """The device's clocks and memory statistics; on the CPU (tests only)
    they read nothing."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0

    def release(self) -> None:
        if self.cuda:
            torch.cuda.empty_cache()

    def kind(self) -> str:
        return torch.cuda.get_device_name(self.device) if self.cuda else "cpu"


def _profiler(card: Card):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card.cuda else [])
    return profile(activities=acts, record_shapes=False, with_stack=False, profile_memory=False)


def _span(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_origin: float,
             chips: int = 1) -> "tuple[dict, list[Check]]":
    """Run ``cell`` once; return the result line (without ``correct``) and
    the checks.  ``t_origin`` is the process's start on the
    ``time.perf_counter`` clock."""
    card = Card(torch.device(device))
    session = cell.entry().Session(cell, cell.fixture().make(cell.config, seed, card.device),
                                   card.device)
    session.call(warm=True)
    card.sync()
    card.reset_peak()
    prof = _profiler(card) if trace else None
    if prof is not None:
        prof.start()
    calls = []
    t_start = time.perf_counter()
    setup_s = t_start - t_origin
    with _span(tracing.WINDOW_RANGE, trace):
        while True:
            a = time.perf_counter()
            with _span(tracing.CALL_RANGE, trace):
                res = session.call()
            card.sync()
            b = time.perf_counter()
            calls.append((a, b, res))
            if b - t_start >= seconds:
                break
    window_s = calls[-1][1] - t_start
    peak = card.peak_bytes()
    device = {"platform": "gpu" if card.cuda else "cpu", "kind": card.kind(), "count": chips,
              "memory_peak_bytes": peak}
    cases = len(calls) * session.cases_per_call
    line: dict = {"attempted": cases, "failed": session.failed([r for _, _, r in calls])}
    if prof is None:
        values = {"scored_pairs_per_s": cases / window_s, "peak_gb": peak / 1e9,
                  "setup_s": setup_s}
    else:
        prof.stop()
        tr = tracing.from_profiler(prof)
        del prof
        lo, hi = tr.window()
        device["busy_s"] = tr.busy()
        device["window_s"] = hi - lo
        ctx = types.SimpleNamespace(trace=tr, calls=calls, session=session, cell=cell,
                                    window_s=window_s, cases=cases)
        values = {quantity(m["name"]): cell.reader(m["name"])(ctx)
                  for m in cell.metrics(trace=True)}
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    # a reader that finds nothing to read leaves its metric out of the line
    line["metrics"] = {m["name"]: {"value": float(values[q]), "unit": m["unit"]}
                       for m in cell.metrics(trace)
                       if values.get(q := quantity(m["name"])) is not None}
    line["device"] = device
    card.release()
    checks = session.judge([r for _, _, r in calls], seed)
    return line, checks
