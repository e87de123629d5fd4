"""What the traced run's profile holds, and the arithmetic the per-layer
readers share: the device's busy time as a union of intervals, the device
time of the kernels launched inside each host range, and the idle gaps
named by what the host was doing.

The profile is read from ``torch.profiler``'s raw event list (one pass, no
trace file): device operations (kernels, copies, fills) with their start,
end and correlation id; the host's CUDA runtime calls, whose correlation id
ties each device operation to the moment it was issued; and the host ranges
opened by ``record_function`` (the program's ``sweep.*`` and the harness's
``regbench.*``).  The attribution of device time to ``sweep.*`` ranges is
the one ``scripts/profile_torch_sweep.py`` makes with ``key_averages``,
done here over the events themselves.
"""

from __future__ import annotations

import bisect
import dataclasses

#: the harness's own ranges: the measured window and each call in it
WINDOW_RANGE = "regbench.window"
CALL_RANGE = "regbench.call"


@dataclasses.dataclass
class Trace:
    """Seconds on one clock.  ``device``: (name, start, end, correlation);
    ``ranges``: (name, start, end) of host ranges; ``issued``:
    correlation id -> host time of the runtime call that issued it."""

    device: "list[tuple[str, float, float, int]]"
    ranges: "list[tuple[str, float, float]]"
    issued: "dict[int, float]"

    def window(self) -> "tuple[float, float]":
        """The traced window: the harness's window range, else the span of
        every event."""
        spans = [(a, b) for n, a, b in self.ranges if n == WINDOW_RANGE]
        if spans:
            return spans[0]
        pts = [a for _, a, _, _ in self.device] + [b for _, _, b, _ in self.device]
        return (min(pts), max(pts)) if pts else (0.0, 0.0)

    def busy(self) -> float:
        """Seconds of the window in which some device operation ran."""
        lo, hi = self.window()
        return union_seconds([(max(a, lo), min(b, hi)) for _, a, b, _ in self.device])

    def named(self, prefix: str) -> "Spans":
        return Spans([r for r in self.ranges if r[0].startswith(prefix)])

    def device_by_range(self, prefix: str = "sweep.") -> "dict[str, float]":
        """Device seconds of the operations issued inside each host range
        whose name starts with ``prefix`` (the innermost such range)."""
        spans = self.named(prefix)
        out: dict = {}
        for _, a, b, corr in self.device:
            t = self.issued.get(corr)
            name = spans.at(t) if t is not None else None
            if name is not None:
                out[name] = out.get(name, 0.0) + (b - a)
        return out

    def device_ops(self, top: int = 10) -> "list[list]":
        """The ``top`` device operation names by total seconds."""
        tot: dict = {}
        for name, a, b, _ in self.device:
            key = name[:120]
            tot[key] = tot.get(key, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> "list[list]":
        """Idle seconds of the window summed by what the host was doing as
        each gap began (or, for a gap that began outside every call, as it
        ended): the innermost ``sweep.*`` range, else the harness's call
        range (the program outside its sweep ranges), else none."""
        lo, hi = self.window()
        sweep, calls = self.named("sweep."), self.named(CALL_RANGE)
        tot: dict = {}
        for a, b in gaps(merge([(x, y) for _, x, y, _ in self.device]), lo, hi):
            t = a if calls.at(a) else b
            name = sweep.at(t) or ("call outside sweep ranges" if calls.at(t) else "between calls")
            tot[name] = tot.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def merge(intervals) -> "list[tuple[float, float]]":
    """Sorted, disjoint union of (start, end) intervals (empty ones
    dropped)."""
    out: list = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_seconds(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def gaps(merged, lo: float, hi: float) -> "list[tuple[float, float]]":
    """The stretches of [lo, hi] that no merged interval covers."""
    out, t = [], lo
    for a, b in merged:
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


class Spans:
    """Host ranges sorted by start, asked which one holds a moment."""

    #: how many earlier-starting ranges :meth:`at` looks back over: ranges
    #: of one thread nest shallowly
    DEPTH = 8

    def __init__(self, ranges):
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self.starts = [r[1] for r in self.ranges]

    def at(self, t: float) -> "str | None":
        """The name of the latest-starting range that holds ``t``."""
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(i - 1 - self.DEPTH, -1), -1):
            name, a, b = self.ranges[j]
            if a <= t <= b:
                return name
        return None


def from_profiler(prof) -> Trace:
    """A :class:`Trace` of a finished ``torch.profiler.profile``."""
    results = prof.profiler.kineto_results
    base = results.trace_start_ns()  # seconds from here keep a nanosecond's resolution
    device, ranges, issued = [], [], {}
    for e in results.events():
        start = (e.start_ns() - base) * 1e-9
        end = start + e.duration_ns() * 1e-9
        name = e.name()
        ours = name.startswith(("sweep.", "regbench."))
        if str(e.device_type()).endswith("CUDA"):
            # a range's mirror on the device stream is no operation
            if not (ours or e.is_user_annotation()):
                device.append((name, start, end, e.correlation_id()))
        elif ours:
            ranges.append((name, start, end))
        elif name.startswith(("cuda", "cu")) and e.correlation_id():
            issued[e.correlation_id()] = start
    return Trace(device, ranges, issued)
