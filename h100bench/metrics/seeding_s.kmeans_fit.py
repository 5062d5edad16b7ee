"""``seeding_s.kmeans_fit``: seconds a traced fit spends seeding, from the
start of its ``kmeans init`` range to the end of the last device event
(kernel, copy or memset) that began inside it, or the range's end where
that is later: the seeding queues work ahead of the host, so the range
alone can end early. Only work the card starts inside the range counts:
the harness's events carry no launch correlation, so a kernel launched
inside the range that starts after it ends is left out, and a seeding
whose host runs far ahead of the card reads short. The mean over the
traced fits; nothing without the program's ranges."""

from h100bench import program_spans, trace


def read(ctx):
    if not ctx.events:
        return None
    init = program_spans.ranges(ctx.events, "kmeans init")
    if not init:
        return None
    device = [e for e in ctx.events if e.kind in trace.DEVICE_KINDS]
    total = 0.0
    for r in init:
        last = max([r.end] + [e.end for e in device if r.start <= e.start < r.end])
        total += last - r.start
    return total / len(init) / 1e6
