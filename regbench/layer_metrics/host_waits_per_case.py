"""``host_waits_per_case``: the times a (setting, pair) case makes the host
wait for the card, the sum of the ``host_waits.*`` counters of the record
the sweep returns on ``SweepResult.counters`` (``utils/trace.py``: each
operation that torch's sync debug mode marks as waiting for the card, by
the span it came in, and each setting's sync) over the window's calls, over
its cases.  Nothing where a call counted no wait."""


def read(ctx):
    total = 0
    for _, _, res in ctx.calls:
        waits = [v for k, v in (getattr(res, "counters", None) or {}).items()
                 if k.startswith("host_waits.")]
        if not waits:
            return None
        total += sum(waits)
    return total / ctx.cases if ctx.cases else None
