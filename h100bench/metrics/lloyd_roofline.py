"""``lloyd_roofline``: the Lloyd passes' least time (the f32 bound of maxIter
iterations of 4·rows·n·k operations, X read once, true rows only) of the
traced fits over the seconds in which a kernel of theirs ran on the card,
in %. Every kernel of the fit counts, whatever its name: the two GEMMs,
the distance expansion, clamp, argmin and sums, the padding's fill, and
the k-means++ draws over a 16,384-row sample, a small part of a fit's
kernel time. Copies and memsets do not count."""

from h100bench import trace, work


def read(ctx):
    if not ctx.events:
        return None
    kernel_s = trace.busy_s(ctx.events, kinds=("kernel",))
    fits = sum(1 for r in ctx.records if r.traced and r.ok)
    if kernel_s <= 0 or not fits:
        return None
    c, p = ctx.config, ctx.config["params"]
    bound = work.lloyd_bound_s(c["rows"], c["n"], p["k"], p["maxIter"])
    return 100.0 * fits * bound / kernel_s
