"""``kmeans_fit_mfu``: the Lloyd products' operations of the completed
untraced fits (maxIter iterations of 4·rows·n·k, true rows only) over
their wall seconds times the f32 peak (TF32 is off), in %. The seeding,
the copies and the host's work are in the wall time and not in the work."""

from h100bench import work


def read(ctx):
    fits = [r for r in ctx.records if r.ok and not r.traced]
    if not fits:
        return None
    c, p = ctx.config, ctx.config["params"]
    flops = p["maxIter"] * work.lloyd_flops(c["rows"], c["n"], p["k"])
    wall = sum(r.end - r.start for r in fits)
    return 100.0 * len(fits) * flops / (wall * work.PEAK_FLOPS["f32"])
