"""PyTorch/CUDA port of spark-rapids-ml-tpu.

A second package beside the JAX one, held against it function by function.
It imports torch and nothing of JAX or of the JAX package. Its entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card the default raises.

It ports PCA whole: the fit with every solver (``full``, ``randomized``,
``svd``, ``auto``) and every precision tier (``highest``, ``high``,
``default``), resident or streamed above the cutover (under the fold's
``TPU_ML_PRECISION_POLICY``) and with or without the fused standardize; the
transform; and save/load in the JAX package's native and Spark ML layouts
(host-side, with pyarrow). The Gram + moments kernels are written by hand
for Hopper (``csrc/gram_moments.cu``): the split's three bf16 products for
``high``, one bf16 pass for ``default`` and the ``bf16_f32acc`` policy.

Beside PCA: the scaler family (``models/scaler.py``), ``Pipeline``
(BASELINE config 4, ``Pipeline([StandardScaler, PCA])``), the quantile
discretizer and the variance selector; every fit books a ``FitReport``
(``telemetry/``), and serving has a health monitor and SLO shedding.

The distance family (BASELINE config 5): ``KMeans`` (inits ``random``,
``k-means++``, ``k-means||``; checkpoint/resume), ``DBSCAN`` and the exact
``NearestNeighbors``, on cuBLAS products (``int8_dist`` on
``torch._int_mm``); ``clustering`` is the drop-in namespace.

The linear family: ``LinearRegression`` (normal equations or elastic net,
resident or streamed with labels and weights), ``LogisticRegression``
(binary and multinomial Newton) and ``LinearSVC`` (squared hinge), with
checkpoint/resume; ``TruncatedSVD``; and the incremental estimators
(``partial_fit``/``finalize``) of PCA, TruncatedSVD, StandardScaler,
LinearRegression and KMeans. Their products over the rows are f32 cuBLAS
matmuls, or the Gram kernels at precision ``high``/``default``.

Approximate nearest neighbours: ``ApproximateNearestNeighbors`` (IVF-Flat,
resident build), the streamed ``IVFFlatIndex`` (``ann``) and the ``"ann"``
servable at ``/v1/indexes``; ``knn`` is the drop-in namespace. The tree
family: ``RandomForestClassifier``/``Regressor`` and the ``DecisionTree``
estimators (histogram trees on the device; classifiers are servable as the
``"forest"`` family). ``NaiveBayes`` (multinomial, bernoulli, gaussian).
"""

from spark_rapids_ml_tpu_torch.models.dbscan import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch.models.discretizer import (
    Bucketizer,
    QuantileDiscretizer,
    QuantileDiscretizerModel,
)
from spark_rapids_ml_tpu_torch.models.incremental import (
    IncrementalKMeans,
    IncrementalLinearRegression,
    IncrementalPCA,
    IncrementalStandardScaler,
    IncrementalTruncatedSVD,
)
from spark_rapids_ml_tpu_torch.models.forest import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.linear import (
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesModel
from spark_rapids_ml_tpu_torch.models.neighbors import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.pipeline import Pipeline, PipelineModel
from spark_rapids_ml_tpu_torch.models.scaler import (
    DCT,
    Binarizer,
    ElementwiseProduct,
    Imputer,
    ImputerModel,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    PolynomialExpansion,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
    VectorSlicer,
)
from spark_rapids_ml_tpu_torch.models.selector import (
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from spark_rapids_ml_tpu_torch.models.truncated_svd import TruncatedSVD, TruncatedSVDModel

__version__ = "0.1.0"

__all__ = [
    "ApproximateNearestNeighbors", "ApproximateNearestNeighborsModel",
    "DBSCAN", "DBSCANModel", "DCT", "Binarizer", "Bucketizer",
    "DecisionTreeClassificationModel", "DecisionTreeClassifier",
    "DecisionTreeRegressionModel", "DecisionTreeRegressor", "ElementwiseProduct", "Imputer",
    "ImputerModel", "IncrementalKMeans", "IncrementalLinearRegression", "IncrementalPCA",
    "IncrementalStandardScaler", "IncrementalTruncatedSVD", "KMeans", "KMeansModel",
    "LinearRegression", "LinearRegressionModel", "LinearSVC", "LinearSVCModel",
    "LogisticRegression", "LogisticRegressionModel", "MaxAbsScaler", "MaxAbsScalerModel",
    "MinMaxScaler", "MinMaxScalerModel", "NaiveBayes", "NaiveBayesModel", "NearestNeighbors",
    "NearestNeighborsModel", "Normalizer",
    "PCA", "PCAModel", "Pipeline", "PipelineModel", "PolynomialExpansion",
    "QuantileDiscretizer", "QuantileDiscretizerModel",
    "RandomForestClassificationModel", "RandomForestClassifier",
    "RandomForestRegressionModel", "RandomForestRegressor", "RobustScaler", "RobustScalerModel",
    "StandardScaler", "StandardScalerModel", "TruncatedSVD", "TruncatedSVDModel",
    "VarianceThresholdSelector", "VarianceThresholdSelectorModel", "VectorSlicer",
    "__version__",
]
