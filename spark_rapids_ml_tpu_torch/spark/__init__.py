"""The Spark glue of the port: the streamed fold (``ingest``), the Arrow
plan functions that run in Spark workers (``arrow_fns``), and the
DataFrame-facing ``SparkPCA`` (``estimators``)."""
