"""``sweep_prep_s``: host seconds a call spends outside the sweep's timed
settings (its scoring sides, label groups, robust-30 sets and ranking),
the call on the harness's clock less the sum of the program's own
``SweepResult.times``, a mean over the window's calls."""


def read(ctx):
    spans = [b - a - float(sum(r.times)) for a, b, r in ctx.calls]
    return sum(spans) / len(spans) if spans else None
