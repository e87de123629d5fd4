"""``score_dev_ms``: device milliseconds a (setting, pair) case of the
operations issued inside the program's ``sweep.evaluate`` and
``sweep.hd95`` ranges (label warp, Dice, Jacobian, the HD95 engine).
Nothing where the program opens neither range."""


def read(ctx):
    by = ctx.trace.device_by_range()
    parts = [by[k] for k in ("sweep.evaluate", "sweep.hd95") if k in by]
    return 1e3 * sum(parts) / ctx.cases if parts else None
