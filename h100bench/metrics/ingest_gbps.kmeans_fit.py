"""``ingest_gbps.kmeans_fit``: the bytes the traced fits copied to the card
(``h2d_bytes`` of the program's report of each, matched to its traced
operation by the wall-clock second it began; ``reports`` stands in for the
program's in tests) over the seconds of their ``kmeans ingest`` ranges, in
GB/s. The bytes also count the k-means++
sample, a few MB against the rows. Nothing without the program's ranges or
reports, or where nothing was copied (the CPU)."""

from h100bench import program_spans


def read(ctx, reports=None):
    if not ctx.events:
        return None
    ingest = program_spans.ranges(ctx.events, "kmeans ingest")
    if reports is None:
        from spark_rapids_ml_tpu_torch.telemetry import recent_reports

        reports = recent_reports()
    nbytes = sum(r.get("h2d_bytes", 0)
                 for r in program_spans.traced_fit_reports(ctx.events, reports))
    seconds = sum(e.end - e.start for e in ingest) / 1e6
    if nbytes <= 0 or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
