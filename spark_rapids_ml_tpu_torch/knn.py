"""Drop-in k-NN namespace mirroring ``spark_rapids_ml.knn``: the exact and
the approximate (IVF-Flat) nearest neighbours of the port.

Counterpart of ``spark_rapids_ml_tpu/knn.py``.
"""

from spark_rapids_ml_tpu_torch.models.neighbors import (  # noqa: F401
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)

__all__ = [
    "ApproximateNearestNeighbors",
    "ApproximateNearestNeighborsModel",
    "NearestNeighbors",
    "NearestNeighborsModel",
]
