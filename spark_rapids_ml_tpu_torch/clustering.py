"""Drop-in clustering namespace mirroring ``pyspark.ml.clustering`` (plus
``DBSCAN``, which spark-rapids-ml exposes from its clustering module)."""

from spark_rapids_ml_tpu_torch.models.dbscan import DBSCAN, DBSCANModel  # noqa: F401
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel  # noqa: F401

__all__ = ["DBSCAN", "DBSCANModel", "KMeans", "KMeansModel"]
