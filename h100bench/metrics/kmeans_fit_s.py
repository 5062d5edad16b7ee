"""``kmeans_fit_s``: the closed loop's seconds per operation, from the first
operation's start to the last completed one's end over the operations
completed (host clock; every operation ends with its answer on the host)."""

from h100bench.loadgen import seconds_per_op


def read(ctx):
    return seconds_per_op(ctx.records)
