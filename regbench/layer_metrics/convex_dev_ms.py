"""``convex_dev_ms``: device milliseconds a (setting, pair) case of the
operations issued inside the program's ``sweep.convex`` ranges (the convex
stage: features, pooling, cost volumes, coupled convex, inverse
consistency).  Nothing where the program opens no such range."""


def read(ctx):
    t = ctx.trace.device_by_range().get("sweep.convex")
    return None if t is None else 1e3 * t / ctx.cases
