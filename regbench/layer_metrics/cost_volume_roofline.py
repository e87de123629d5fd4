"""``cost_volume_roofline``: the window's cost volumes against their bound,
in percent: the sum over every cost volume the calls computed of its least
time on the card (``rb.roofline.cost_volume_bound_s``, from the case's own
channels, coarse grid and displacement range, each input read once and the
volume written once) over the summed device time of every operation whose
name holds ``cost_volume``, whatever kernel does the work.  Nothing where
no such operation ran."""

from rb.roofline import cost_volume_bound_s


def read(ctx):
    spent = sum(b - a for name, a, b, _ in ctx.trace.device if "cost_volume" in name)
    if spent <= 0:
        return None
    bound = len(ctx.calls) * sum(cost_volume_bound_s(*cv) for cv in ctx.session.cost_volumes())
    return 100.0 * bound / spent
