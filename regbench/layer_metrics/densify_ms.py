"""``densify_ms``: the card's milliseconds a pair of the program's
``task1.densify`` spans (task 1's thin-plate-spline densification: the
control points, the field's upload, the spline's fit and evaluation, the
upsample, the box passes and the copy back to the host), each the stream
time between the span's two CUDA events, read from the record the call
returns (``spans``, ``utils/trace.py``), summed over the window's calls.
Nothing where a call returned no such span, or one without a stream time
(off the card)."""


def read(ctx):
    total = 0.0
    for _, _, res in ctx.calls:
        spans = [s for s in getattr(res, "spans", None) or () if s.name == "task1.densify"]
        if not spans or any(s.stream_ms is None for s in spans):
            return None
        total += sum(s.stream_ms for s in spans)
    return total / ctx.cases if ctx.cases else None
