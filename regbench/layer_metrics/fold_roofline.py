"""``fold_roofline``: the window's launches of the coupled argmin's fold
against their bound, in percent: the bound of the launches seen in the
device trace (operations whose name holds ``coupled_argmin_fold``), each
its least time on the card at the one class of the cell's launches
(``Session.fold_class``; ``rb.fold.fold_bound_s``: its float32 costs read
once at 3.35 TB/s), over their summed device time.  Nothing where no such
operation ran, where the cell's session names no class, or where the
trace holds another number of launches than the program counted
(``coupled_argmin.kernel`` in the records the calls return), since a trace
the profiler left short is not read."""

from rb.fold import fold_bound_s


def read(ctx):
    fold_class = getattr(ctx.session, "fold_class", None)
    seen = [b - a for name, a, b, _ in ctx.trace.device if "coupled_argmin_fold" in name]
    made = sum((getattr(res, "counters", None) or {}).get("coupled_argmin.kernel", 0)
               for _, _, res in ctx.calls)
    if fold_class is None or not seen or len(seen) != made:
        return None
    return 100.0 * len(seen) * fold_bound_s(*fold_class()) / sum(seen)
