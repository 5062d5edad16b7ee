"""Drop-in classification namespace mirroring ``pyspark.ml.classification``
(SURVEY.md §1 L6).

Counterpart of ``spark_rapids_ml_tpu/classification.py``: the same names.
"""

from spark_rapids_ml_tpu_torch.models.fm import (  # noqa: F401
    FMClassificationModel,
    FMClassifier,
)
from spark_rapids_ml_tpu_torch.models.forest import (  # noqa: F401
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    RandomForestClassificationModel,
    RandomForestClassifier,
)
from spark_rapids_ml_tpu_torch.models.gbt import (  # noqa: F401
    GBTClassificationModel,
    GBTClassifier,
)
from spark_rapids_ml_tpu_torch.models.linear import (  # noqa: F401
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.mlp import (  # noqa: F401
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import (  # noqa: F401
    NaiveBayes,
    NaiveBayesModel,
)
from spark_rapids_ml_tpu_torch.models.ovr import (  # noqa: F401
    OneVsRest,
    OneVsRestModel,
)

__all__ = [
    "DecisionTreeClassifier",
    "DecisionTreeClassificationModel",
    "FMClassifier",
    "FMClassificationModel",
    "GBTClassifier",
    "GBTClassificationModel",
    "LinearSVC",
    "LinearSVCModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "MultilayerPerceptronClassifier",
    "MultilayerPerceptronClassificationModel",
    "NaiveBayes",
    "NaiveBayesModel",
    "OneVsRest",
    "OneVsRestModel",
    "RandomForestClassifier",
    "RandomForestClassificationModel",
]
