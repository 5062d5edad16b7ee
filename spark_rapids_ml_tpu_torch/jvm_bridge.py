"""JVM delegation entry point: the Scala shim's Python side, on the card.

The reference's product is a Scala estimator usable from JVM Spark with
zero code change (PCA.scala:27-37). Its engine lives in the executor JVM;
this framework's engine is Python, so the JVM story inverts: a thin Scala
estimator (``jvm/`` at the repo root) hands the data off and a module like
this one runs the fit. This is the port's copy of the JAX package's
``jvm_bridge``, with the same subcommands, flags, defaults, messages and
output layouts, running on ``--device`` (default ``cuda``).

Contract (public Spark APIs only):

1. the Scala ``com.nvidia.spark.ml.feature.PCA``-shaped estimator writes
   ``dataset.select(inputCol)`` as parquet to a scratch dir;
2. it execs ``python -m <package>.jvm_bridge fit-pca --input <dir>
   --output <dir> ...`` (driver-side; the shim names the JAX package's
   module, and this one takes the same arguments);
3. the model is written in ``layout="spark"``, the stock Spark ML on-disk
   shape, so the Scala side finishes with
   ``org.apache.spark.ml.feature.PCAModel.load(path)``.

For batch inference the Scala ``TpuPCAModel`` wrapper execs the
``transform-pca`` subcommand: staged parquet in, the card's projection out,
row alignment carried by a row-id column.

The parquet I/O (pyarrow) is kept apart from the two compute halves,
:func:`fit_pca_matrix` (a fit from a matrix) and :func:`project_batches`
(the projection of a sequence of batches), so that they run where pyarrow
is absent; the CLI is the same code with parquet around it. Argument
parsing comes before the bounded device probe, so ``--help`` and usage
errors never touch a device, and a card that does not answer ends the
process with a message instead of hanging the invoking JVM. There is no
fallback to the CPU: ``--device cpu`` asks for it.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, Iterator

DEFAULT_BATCH_ROWS = 1 << 16


def fit_pca_matrix(
    x,
    *,
    k: int,
    input_col: str = "features",
    output_col: str = "pca_features",
    mean_centering: bool = False,
    solver: str = "full",
    num_partitions: int | None = None,
    device: str = "cuda",
):
    """The fit half of ``fit-pca``: a ``PCAModel`` of the [rows, n] matrix
    ``x``, fitted on ``device`` in ``num_partitions`` row partitions."""
    from spark_rapids_ml_tpu_torch.models.pca import PCA

    est = (
        PCA(device=device)
        .setInputCol(input_col)
        .setOutputCol(output_col)
        .setK(k)
        .setMeanCentering(mean_centering)
        .setSolver(solver)
    )
    return est.fit(x, num_partitions=num_partitions)


def project_batch(model, x):
    """One [rows, n] batch's projection on the model's device, as the
    float64 [rows, k] array ``transform-pca`` writes."""
    import numpy as np

    return np.asarray(model._project_matrix(x), dtype=np.float64)


def project_batches(model, batches: Iterable) -> Iterator:
    """The compute half of ``transform-pca``: each batch's projection, in
    order, one batch at a time, so host memory stays O(batch)."""
    for x in batches:
        yield project_batch(model, x)


def _read_matrix(input_path: str, input_col: str):
    import numpy as np
    import pyarrow.dataset as pads

    from spark_rapids_ml_tpu_torch.utils import columnar

    table = pads.dataset(input_path, format="parquet").to_table()
    if input_col not in table.column_names:
        raise SystemExit(
            f"column {input_col!r} not in {input_path} "
            f"(has: {table.column_names})"
        )
    mats = [
        columnar.extract_matrix(batch, input_col)
        for batch in table.to_batches()
        if batch.num_rows
    ]
    if not mats:
        raise SystemExit(f"no rows under {input_path}")
    return np.concatenate(mats, axis=0)


def fit_pca(args: argparse.Namespace) -> None:
    x = _read_matrix(args.input, args.input_col)
    model = fit_pca_matrix(
        x,
        k=args.k,
        input_col=args.input_col,
        output_col=args.output_col,
        mean_centering=args.mean_centering,
        solver=args.solver,
        num_partitions=args.num_partitions,
        device=args.device,
    )
    model.save(args.output, overwrite=True, layout=args.layout)
    print(
        f"fit-pca ok rows={x.shape[0]} n={x.shape[1]} k={args.k} "
        f"-> {args.output} ({args.layout} layout)",
        file=sys.stderr,
    )


def transform_pca(args: argparse.Namespace) -> None:
    """Batch transform for the JVM shim: streams the staged parquet batch by
    batch, projects each batch's input column on the card and writes ALL
    staged columns plus the appended ``list<float64>`` projection column.
    Within every written batch the projection is row-aligned with the staged
    columns; across systems the Scala ``TpuPCAModel`` stages a row-id column
    beside the input and joins the projection back on it."""
    import pyarrow as pa
    import pyarrow.dataset as pads
    import pyarrow.parquet as pq

    from spark_rapids_ml_tpu_torch.models.pca import PCAModel
    from spark_rapids_ml_tpu_torch.utils import columnar

    model = PCAModel.load(args.model, device=args.device)  # native OR stock-Spark layout
    ds = pads.dataset(args.input, format="parquet")
    if args.input_col not in ds.schema.names:
        raise SystemExit(
            f"column {args.input_col!r} not in {args.input} "
            f"(has: {ds.schema.names})"
        )
    if args.output_col in ds.schema.names:
        raise SystemExit(
            f"output column {args.output_col!r} already exists in the input"
        )
    out_field = pa.field(args.output_col, pa.list_(pa.float64()), nullable=False)
    out_schema = pa.schema(list(ds.schema) + [out_field])
    os.makedirs(args.output, exist_ok=True)
    rows = 0
    out_path = os.path.join(args.output, "part-00000.parquet")
    with pq.ParquetWriter(out_path, out_schema) as writer:
        for batch in ds.to_batches(batch_size=args.batch_rows):
            if not batch.num_rows:
                continue
            proj = project_batch(model, columnar.extract_matrix(batch, args.input_col))
            proj_col = pa.FixedSizeListArray.from_arrays(
                pa.array(proj.reshape(-1)), proj.shape[1]
            ).cast(pa.list_(pa.float64()))
            writer.write_batch(
                pa.record_batch(list(batch.columns) + [proj_col], schema=out_schema)
            )
            rows += batch.num_rows
    if not rows:
        raise SystemExit(f"no rows under {args.input}")
    print(
        f"transform-pca ok rows={rows} k={model.pc.shape[1]} "
        f"-> {args.output}",
        file=sys.stderr,
    )


def _claim_device(device: str) -> None:
    """Bounded probe of ``device`` for this fresh interpreter: a card that is
    absent or does not answer within ``TPU_ML_WORKER_PROBE_TIMEOUT``
    seconds ends the process with the probe's message, never a hang and
    never a silent fall back to the CPU."""
    from spark_rapids_ml_tpu_torch.utils import devicepolicy

    try:
        devicepolicy.use_platform(device)
    except devicepolicy.DevicePolicyError as e:
        raise SystemExit(
            f"jvm_bridge: {e} (pass --device cpu to run on the host)"
        ) from None


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="spark_rapids_ml_tpu_torch.jvm_bridge",
        description="Driver-side fit entry point for the JVM (Scala) shim",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("fit-pca", help="fit PCA from a parquet handoff")
    p.add_argument("--input", required=True, help="parquet dir of the input column")
    p.add_argument("--output", required=True, help="model output dir")
    p.add_argument("--input-col", default="features")
    p.add_argument("--output-col", default="pca_features")
    p.add_argument("--k", type=int, required=True)
    p.add_argument("--mean-centering", action="store_true")
    p.add_argument(
        "--solver", default="full", choices=["full", "randomized", "svd", "auto"]
    )
    p.add_argument(
        "--layout",
        default="spark",
        choices=["spark", "native"],
        help="'spark' (default) = stock pyspark.ml layout, loadable by "
        "org.apache.spark.ml.feature.PCAModel.load",
    )
    p.add_argument(
        "--num-partitions",
        type=int,
        default=None,
        help="row partitions for the local fit (default: one)",
    )
    p.set_defaults(func=fit_pca)

    t = sub.add_parser(
        "transform-pca",
        help="project a staged parquet dataset on the card (batch inference "
        "for the JVM shim's TpuPCAModel)",
    )
    t.add_argument("--input", required=True, help="parquet dir of staged rows")
    t.add_argument(
        "--model",
        required=True,
        help="model dir (native or stock-Spark-ML layout, auto-detected)",
    )
    t.add_argument("--output", required=True, help="parquet output dir")
    t.add_argument("--input-col", default="features")
    t.add_argument("--output-col", default="pca_features")
    t.add_argument(
        "--batch-rows",
        type=int,
        default=DEFAULT_BATCH_ROWS,
        help="rows per streamed projection batch (host memory bound)",
    )
    t.set_defaults(func=transform_pca)
    for command in (p, t):
        command.add_argument(
            "--device",
            default="cuda",
            choices=["cuda", "cpu"],
            help="where the fit or projection runs (default: cuda; no "
            "fallback to the CPU when the card does not answer)",
        )

    args = parser.parse_args(argv)
    # after parsing: --help and usage errors never touch a device
    _claim_device(args.device)
    args.func(args)


if __name__ == "__main__":
    main()
