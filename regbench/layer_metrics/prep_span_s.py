"""``prep_span_s``: host seconds a call spends inside the program's
``sweep.prep`` span, read from the record the sweep returns on
``SweepResult.spans`` (the robust-30 sets, the host-to-card copies, the
label groups, the HD95 sides and the kernel load; ``utils/trace.py``), a
mean over the window's calls.  Nothing where a call returned no such
span."""


def read(ctx):
    secs = []
    for _, _, res in ctx.calls:
        spans = [s for s in getattr(res, "spans", None) or () if s.name == "sweep.prep"]
        if not spans:
            return None
        secs.append(sum(s.end_ns - s.start_ns for s in spans) / 1e9)
    return sum(secs) / len(secs) if secs else None
