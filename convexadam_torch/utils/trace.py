"""Spans and counters of the port's layers, on while a ``torch.profiler``
records.

:func:`span` brackets a stretch of work by name; :func:`count` adds to
a named counter.  They are on exactly
while the autograd profiler records (``torch.profiler.profile``,
``utils/memory.py:profile_trace``); otherwise a span is one flag check and
a shared null context, and a counter one check: no range, event, clock read
or wait.  While on, a span opens a ``record_function`` range of its name
and, inside a :func:`recording` (each sweep call opens one and returns it
on its ``SweepResult``; ``pipeline/challenges.py:task1_validation`` opens
one a call and returns it on its ``Task1Validation``), appends a
:class:`Span` to the record: its name,
the index of the span that encloses it (-1 at the top), its case
``(setting, pair)`` (inherited from the enclosing span when not given), its
host start and end, and its stream time.  Counters count inside a record
only.

Host waits: while a record runs on a card (:func:`on_device`), torch's
sync debug mode (``torch.cuda.set_sync_debug_mode("warn")``) warns at each
operation that makes the host wait for a stream (``.item()``, ``.cpu()``,
``nonzero``, a copy from pageable memory), and the record counts each such
warning as ``host_waits.<span>``, after the innermost span open when it
came (``host_waits.unspanned`` outside every span).  So the count is of the
waits torch sees, not of waits declared in the code.  The mode does not
watch ``torch.cuda.synchronize``; a sweep counts its own
(``host_waits.setting_sync``).

Clocks: ``start_ns`` and ``end_ns`` are ``time.perf_counter_ns``, the
host's monotonic clock; the ``record_function`` range puts the same span on
the profiler's clock, beside the device operations it issued, which is what
a reader of the device trace attributes by range.  ``stream_ms`` is the
card's own: the elapsed time between two ``torch.cuda.Event`` recorded on
the current stream at the span's entry and exit (the stream's idle
stretches between them count; work queued before the span does not),
``None`` off the card.  It is read when the record closes, after the
sweep's last fetch, so it adds no wait inside the sweep; it needs no
profiler activity of its own, so it reads where the profiler sees no device
time.

Names: the benchmark's trace reader gives each device operation to the
innermost open range whose name starts with ``sweep.``, and reads the four
ranges ``sweep.convex``, ``sweep.evaluate``, ``sweep.hd95`` and
``sweep.fetch`` by name.  So spans inside those ranges take other prefixes
(``convex.*``, ``hd95.*``), which leave those readings as they are, and
``sweep.`` names stand only outside them (``sweep.prep.*``,
``sweep.rescore``), where they name work no range held before.  The
registration's own layers keep off the prefix too: ``adam.*`` (the Adam
stage's inputs, loop and upsample; the loop also inside ``sweep.adam`` in
stage 2),
``tps.*`` (the spline's fit, evaluation and smoothing) and ``task1.*``
(task 1's pair, registration, densification, original-space map and
scores), with the counters ``adam.steps`` and ``tps.control_points``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import torch
from torch.profiler import record_function

#: the autograd profiler's own enabled flag
_enabled = torch._C._autograd._profiler_enabled

#: what torch's sync debug mode warns at an operation that waits for the card
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()


@dataclasses.dataclass(slots=True)
class Span:
    """One span of a :class:`Record`."""

    name: str
    parent: int  # index of the enclosing span in the record, -1 at the top
    case: "tuple | None"  # (setting, pair); either may be None
    start_ns: int
    end_ns: int = 0
    stream_ms: "float | None" = None


class Record:
    """The spans (in the order they opened) and counters of one call of a
    sweep or of ``task1_validation``."""

    def __init__(self):
        self.spans: "list[Span]" = []
        self.counters: "dict[str, int]" = {}
        self.stream_device = None  # the card whose current stream times the spans
        self.open: "list[int]" = []
        self.events: list = []  # (span index, entry event, exit event)
        self.last = None  # the exit event recorded last
        self.sync_mode = None  # the sync debug mode :func:`on_device` replaced

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.stream_device))
        return ev

    def resolve(self) -> None:
        """Fill each span's ``stream_ms`` from its events."""
        if self.last is not None and not self.last.query():
            self.last.synchronize()
        for i, a, b in self.events:
            self.spans[i].stream_ms = a.elapsed_time(b)
        self.events.clear()
        self.last = None


_records: "list[Record]" = []  # the open records, innermost last


class _Span:
    __slots__ = ("name", "case", "range", "rec", "index", "entry")

    def __init__(self, name: str, case):
        self.name, self.case = name, case

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        start = time.perf_counter_ns()  # next to the range's own start
        self.rec = rec = _records[-1] if _records else None
        if rec is not None:
            parent = rec.open[-1] if rec.open else -1
            case = self.case
            if case is None and parent >= 0:
                case = rec.spans[parent].case
            self.index = len(rec.spans)
            self.entry = rec._event() if rec.stream_device is not None else None
            rec.spans.append(Span(self.name, parent, case, start))
            rec.open.append(self.index)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if self.entry is not None:
                rec.last = rec._event()
                rec.events.append((self.index, self.entry, rec.last))
            rec.open.pop()
            rec.spans[self.index].end_ns = time.perf_counter_ns()  # next to the range's end
        self.range.__exit__(*exc)
        return False


def span(name: str, case=None):
    """A context that spans its block as ``name`` while a profiler records
    (module docstring); ``case`` is the ``(setting, pair)`` it works on."""
    if not _enabled():
        return _NULL
    return _Span(name, case)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the open record while a
    profiler records."""
    if _records and _enabled():
        c = _records[-1].counters
        c[name] = c.get(name, 0) + n


def _count_sync(show):
    """A ``warnings.showwarning`` that counts the sync debug mode's warnings
    into the open record (module docstring) and hands others to ``show``."""
    def seen(message, category, filename, lineno, file=None, line=None):
        if not (_records and SYNC_MESSAGE in str(message)):
            return show(message, category, filename, lineno, file, line)
        rec = _records[-1]
        count("host_waits." + (rec.spans[rec.open[-1]].name if rec.open else "unspanned"))
    return seen


def on_device(device: torch.device) -> None:
    """Time the open record's spans on ``device``'s current stream, and
    count its host waits, where it is a card (off the card they keep
    ``stream_ms`` None and count none)."""
    if _records and _enabled() and device.type == "cuda":
        rec = _records[-1]
        rec.stream_device = device
        if rec.sync_mode is None:
            rec.sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")


@contextlib.contextmanager
def recording():
    """Open a record for one call; spans and counters of the block
    go to it (to the innermost record when they nest), and its stream times
    are read when the block ends."""
    rec = Record()
    _records.append(rec)
    try:
        with warnings.catch_warnings():
            if _enabled():
                warnings.filterwarnings("always", message=SYNC_MESSAGE)
                warnings.showwarning = _count_sync(warnings.showwarning)
            try:
                yield rec
            finally:
                if rec.sync_mode is not None:
                    torch.cuda.set_sync_debug_mode(rec.sync_mode)
    finally:
        _records.remove(rec)
        rec.resolve()
