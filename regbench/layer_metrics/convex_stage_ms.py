"""``convex_stage_ms``: the card's milliseconds a pair of the program's
convex stage inside task 1's registration: the ``convex.*`` spans
(features, pooling, cost volumes with their box passes, the coupled
argmin, inverse consistency, upsample) that no other ``convex.*`` span
encloses, under a ``task1.register`` span, each the stream time between
its two CUDA events, read from the record the call returns (``spans``,
``utils/trace.py``), summed over the window's calls.  Nothing where a call
returned no such span, or one without a stream time (off the card)."""


def _stage(spans):
    """The outermost ``convex.*`` spans under ``task1.register``."""
    out = []
    for s in spans:
        if not s.name.startswith("convex."):
            continue
        p, inside = s.parent, False
        while p >= 0 and not inside:
            if spans[p].name.startswith("convex."):
                break
            inside, p = spans[p].name == "task1.register", spans[p].parent
        if inside:
            out.append(s)
    return out


def read(ctx):
    total = 0.0
    for _, _, res in ctx.calls:
        spans = _stage(getattr(res, "spans", None) or ())
        if not spans or any(s.stream_ms is None for s in spans):
            return None
        total += sum(s.stream_ms for s in spans)
    return total / ctx.cases if ctx.cases else None
