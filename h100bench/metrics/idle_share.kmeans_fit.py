"""``idle_share.kmeans_fit``: the share of the traced window in which neither a kernel nor
a copy nor a memset ran on the card (profiler), in %."""

from h100bench import trace


def read(ctx):
    share = trace.busy_share(ctx.events) if ctx.events else None
    return None if share is None else 100.0 * (1.0 - share)
