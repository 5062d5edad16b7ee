"""Serve-path shape bucketing: power-of-two row buckets and zero padding.

Port of ``spark_rapids_ml_tpu/serving/buckets.py``; every function gives
the JAX function's result for every input and knob setting. A scoring
request is often one row, so the serve ladder starts at
``TPU_ML_SERVE_MIN_BUCKET`` (default 8), not at the fit's 128, and stops at
``TPU_ML_SERVE_MAX_BATCH_ROWS`` (default 4096). The cap bounds one
micro-batched dispatch and makes the set of shapes enumerable: the
registry captures one CUDA graph per rung of ``bucket_ladder`` at
registration, so after it no request size can miss the captured set.

Zero padding is exact for the projection (rows are independent), so a pad
row only affects its own discarded output row; ``pad_to_bucket`` returns
the valid-row count beside the padded block.
"""

from __future__ import annotations

import math

import numpy as np

from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_SERVE_MAX_BATCH_ROWS,
    DEFAULT_SERVE_MIN_BUCKET,
    SERVE_MAX_BATCH_ROWS_VAR,
    SERVE_MIN_BUCKET_VAR,
    lenient_int,
)


def min_bucket() -> int:
    """Serve-path bucket floor (``TPU_ML_SERVE_MIN_BUCKET``), rounded up to
    a power of two >= 1."""
    floor = max(1, lenient_int(SERVE_MIN_BUCKET_VAR, DEFAULT_SERVE_MIN_BUCKET))
    return 1 << math.ceil(math.log2(floor))


def max_batch_rows() -> int:
    """Serve-path bucket cap (``TPU_ML_SERVE_MAX_BATCH_ROWS``), rounded up to
    a power of two and never below ``min_bucket``."""
    cap = max(1, lenient_int(SERVE_MAX_BATCH_ROWS_VAR, DEFAULT_SERVE_MAX_BATCH_ROWS))
    return max(min_bucket(), 1 << math.ceil(math.log2(cap)))


def serve_bucket(rows: int) -> int:
    """A request's row count rounded up to its serve bucket; raises
    ``ValueError`` above the ladder cap (HTTP 413 at admission)."""
    if rows <= 0:
        raise ValueError(f"request must have at least one row (got {rows})")
    cap = max_batch_rows()
    if rows > cap:
        raise ValueError(
            f"request of {rows} rows exceeds the serve ladder cap {cap} "
            f"({SERVE_MAX_BATCH_ROWS_VAR}) — split the request or raise "
            "the cap"
        )
    return max(min_bucket(), 1 << math.ceil(math.log2(rows)))


def bucket_ladder() -> tuple[int, ...]:
    """Every serve bucket, smallest to largest: the fixed set of row shapes
    the registry captures per model at registration."""
    lo, hi = min_bucket(), max_batch_rows()
    out = []
    b = lo
    while b <= hi:
        out.append(b)
        b *= 2
    return tuple(out)


def pad_to_bucket(x: np.ndarray, bucket: int | None = None) -> tuple[np.ndarray, int]:
    """Zero-pad a [rows, n] block to its serve bucket, or to ``bucket`` (the
    micro-batcher's coalescing key) when it holds the rows. Returns
    ``(padded, true_rows)``; a block already at its bucket comes back as
    itself."""
    rows = x.shape[0]
    if bucket is None:
        bucket = serve_bucket(rows)
    elif rows > bucket:
        raise ValueError(f"{rows} rows do not fit the requested bucket {bucket}")
    if bucket == rows:
        return x, rows
    out = np.zeros((bucket, x.shape[1]), dtype=x.dtype)
    out[:rows] = x
    return out, rows
