"""localspark: a pyspark-API-compatible local execution engine for the port.

Port of ``spark_rapids_ml_tpu/localspark``, which the port may not import
(its workers would run the JAX package). It does the same two jobs:

1. **Execution proof for the Spark integration.** ``DataFrame.mapInArrow``
   ships the plan function to a separate worker process, cloudpickled, the
   data crossing as Arrow IPC streams and the output checked against the
   declared schema, so the failures Spark brings (closure pickling, cold
   imports, schema mismatches) show without a JVM.
2. **Standalone mode.** ``spark/estimators.py``'s ``SparkPCA`` takes these
   DataFrames as it takes pyspark's (``utils.columnar.is_spark_dataframe``).

The surface is the ``pyspark.sql`` subset the estimators use:
``LocalSparkSession.createDataFrame``, ``DataFrame.{select, where, limit,
sample, randomSplit, repartition, mapInArrow, collect, first, count,
toArrow, schema}``, ``types.{StructType, StructField, ArrayType,
DoubleType, ...}``, ``functions.{col, rand, lit}``.

It needs pyarrow and cloudpickle, so the package never imports it eagerly.
Its workers run on the card by default (``worker_platform="cuda"``).
"""

from spark_rapids_ml_tpu_torch.localspark import functions, types
from spark_rapids_ml_tpu_torch.localspark.dataframe import DataFrame, Row
from spark_rapids_ml_tpu_torch.localspark.session import LocalSparkSession

__all__ = [
    "DataFrame",
    "LocalSparkSession",
    "Row",
    "functions",
    "types",
]
