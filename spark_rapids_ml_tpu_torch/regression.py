"""Drop-in regression namespace mirroring ``pyspark.ml.regression``
(SURVEY.md §1 L6).

Counterpart of ``spark_rapids_ml_tpu/regression.py``: the same names.
``LinearRegression`` above the ``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES``
cutover streams chunk-wise (``spark.ingest``).
"""

from spark_rapids_ml_tpu_torch.models.fm import (  # noqa: F401
    FMRegressionModel,
    FMRegressor,
)
from spark_rapids_ml_tpu_torch.models.forest import (  # noqa: F401
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.gbt import (  # noqa: F401
    GBTRegressionModel,
    GBTRegressor,
)
from spark_rapids_ml_tpu_torch.models.isotonic import (  # noqa: F401
    IsotonicRegression,
    IsotonicRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.linear import (  # noqa: F401
    LinearRegression,
    LinearRegressionModel,
)

__all__ = [
    "DecisionTreeRegressor",
    "DecisionTreeRegressionModel",
    "FMRegressor",
    "FMRegressionModel",
    "GBTRegressor",
    "GBTRegressionModel",
    "IsotonicRegression",
    "IsotonicRegressionModel",
    "LinearRegression",
    "LinearRegressionModel",
    "RandomForestRegressor",
    "RandomForestRegressionModel",
]
