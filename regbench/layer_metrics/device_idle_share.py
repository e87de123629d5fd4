"""``device_idle_share``: the share of the traced window, in percent, in
which no operation ran on the card: one less the union of the device
operations' intervals over the window's length (a union, so overlapping
operations count once)."""


def read(ctx):
    lo, hi = ctx.trace.window()
    if hi <= lo:
        return None
    return 100.0 * (1.0 - ctx.trace.busy() / (hi - lo))
