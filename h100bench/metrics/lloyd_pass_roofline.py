"""``lloyd_pass_roofline``: the f32 bound of the traced fits' Lloyd
iterations (4·rows·n·k operations and X read once, true rows only, for each
``kmeans lloyd iteration`` range of the program in the trace) over the
seconds in which a kernel was in flight inside their ``kmeans lloyd``
ranges, in %. The seeding's and the ingest's kernels are left out, as are
copies and memsets. Nothing without the program's ranges."""

from h100bench import program_spans, trace, work


def read(ctx):
    if not ctx.events:
        return None
    lloyd = program_spans.ranges(ctx.events, "kmeans lloyd")
    iterations = len(program_spans.ranges(ctx.events, "kmeans lloyd iteration"))
    kernels = trace.device_intervals(ctx.events, kinds=("kernel",))
    kernel_s = sum(trace.length(trace.clip(kernels, r.start, r.end)) for r in lloyd) / 1e6
    if kernel_s <= 0 or not iterations:
        return None
    c, p = ctx.config, ctx.config["params"]
    return 100.0 * work.lloyd_bound_s(c["rows"], c["n"], p["k"], iterations) / kernel_s
