"""``adam_ms``: the card's milliseconds a pair of the program's
``adam.loop`` spans (the Adam stage's iterations: smoothing, regulariser,
data term, backward pass and optimiser step), each the stream time between
the span's two CUDA events, read from the record the call returns
(``spans``, ``utils/trace.py``), summed over the window's calls.  The
stream's idle stretches inside the loop count: the loop is issued by the
host.  Nothing where a call returned no such span, or one without a stream
time (off the card)."""


def read(ctx):
    total = 0.0
    for _, _, res in ctx.calls:
        spans = [s for s in getattr(res, "spans", None) or () if s.name == "adam.loop"]
        if not spans or any(s.stream_ms is None for s in spans):
            return None
        total += sum(s.stream_ms for s in spans)
    return total / ctx.cases if ctx.cases else None
