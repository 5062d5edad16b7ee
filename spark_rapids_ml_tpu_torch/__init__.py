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

Boosting, the networks and the manifold family: ``GBTClassifier``/
``GBTRegressor`` (a variance tree per stage on the forest's histograms),
``MultilayerPerceptronClassifier`` (L-BFGS or SGD) and ``FMClassifier``/
``FMRegressor`` (AdamW or SGD), trained by autograd on the device with the
port's own reproductions of optax's optimizers (``ops/optim.py``); ``UMAP``
(the k-NN graph, calibration and layout on the device); and the host
meta-estimators ``OneVsRest`` and ``IsotonicRegression``. ``classification``,
``regression`` and ``umap`` are the drop-in namespaces.

Feature engineering, text and model selection: ``VectorAssembler``,
``StringIndexer``, ``OneHotEncoder``, ``IndexToString``, ``Tokenizer``,
``HashingTF`` and ``IDF`` (host stages; ``feature`` is the drop-in
namespace), and ``ParamGridBuilder``, the four evaluators,
``CrossValidator`` and ``TrainValidationSplit``, whose candidate fits run
the port's estimators on the card. ``resilience`` holds the fault plans
(``TPU_ML_FAULT_PLAN``), the error classifier and the retry policy that
the streamed fold (checkpoint and resume, OOM bisection, a bounded wait)
and the partition executor (retries, straggler hedging) recover with;
``utils/devicepolicy.py`` the worker environments and bounded device
probes.

The Spark glue: every ``Spark*`` estimator and model of the JAX package's
``spark`` namespace (``spark/estimators.py``: PCA, TruncatedSVD, the
linear family, KMeans, the scalers and selectors, the stateless stages,
the neighbours, DBSCAN and the collect-and-fit families) fits and
transforms a pyspark DataFrame, or one of the port's own local engine
(``localspark``: worker processes, Arrow IPC, cloudpickle), on the
driver-merge distribution, through the Arrow plan functions of
``spark/arrow_fns.py``, whose partition bodies run on the card; model
selection takes such a DataFrame too. Both need pyarrow and cloudpickle,
so the package imports neither eagerly: the ``Spark*`` names load on
first use.
Every fit's ``FitReport`` carries the analytical cost model
(``telemetry/costmodel.py``) and the tuner's decisions
(``autotune/search.py``: successive halving over the streamed fold's chunk
rows, ``TPU_ML_AUTOTUNE``).
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
from spark_rapids_ml_tpu_torch.models.feature_eng import (
    IndexToString,
    OneHotEncoder,
    OneHotEncoderModel,
    StringIndexer,
    StringIndexerModel,
    VectorAssembler,
)
from spark_rapids_ml_tpu_torch.models.fm import (
    FMClassificationModel,
    FMClassifier,
    FMRegressionModel,
    FMRegressor,
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
from spark_rapids_ml_tpu_torch.models.gbt import (
    GBTClassificationModel,
    GBTClassifier,
    GBTRegressionModel,
    GBTRegressor,
)
from spark_rapids_ml_tpu_torch.models.isotonic import IsotonicRegression, IsotonicRegressionModel
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.linear import (
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.models.mlp import (
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesModel
from spark_rapids_ml_tpu_torch.models.neighbors import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.ovr import OneVsRest, OneVsRestModel
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
from spark_rapids_ml_tpu_torch.models.text import IDF, HashingTF, IDFModel, Tokenizer
from spark_rapids_ml_tpu_torch.models.truncated_svd import TruncatedSVD, TruncatedSVDModel
from spark_rapids_ml_tpu_torch.models.tuning import (
    BinaryClassificationEvaluator,
    ClusteringEvaluator,
    CrossValidator,
    CrossValidatorModel,
    MulticlassClassificationEvaluator,
    ParamGridBuilder,
    RegressionEvaluator,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel

__version__ = "0.1.0"

# loaded on first use: the Spark glue's modules need pyarrow at run time
from spark_rapids_ml_tpu_torch.spark import _ESTIMATORS as _SPARK_NAMES  # noqa: E402

_LAZY = {name: "spark.estimators" for name in _SPARK_NAMES}


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)

__all__ = [
    "ApproximateNearestNeighbors", "ApproximateNearestNeighborsModel", "Binarizer",
    "BinaryClassificationEvaluator", "Bucketizer", "ClusteringEvaluator", "CrossValidator",
    "CrossValidatorModel", "DBSCAN", "DBSCANModel", "DCT",
    "DecisionTreeClassificationModel", "DecisionTreeClassifier",
    "DecisionTreeRegressionModel", "DecisionTreeRegressor", "ElementwiseProduct",
    "FMClassificationModel", "FMClassifier", "FMRegressionModel", "FMRegressor",
    "GBTClassificationModel", "GBTClassifier", "GBTRegressionModel", "GBTRegressor",
    "HashingTF", "IDF", "IDFModel", "Imputer", "ImputerModel", "IncrementalKMeans",
    "IncrementalLinearRegression", "IncrementalPCA", "IncrementalStandardScaler",
    "IncrementalTruncatedSVD", "IndexToString", "IsotonicRegression",
    "IsotonicRegressionModel", "KMeans", "KMeansModel", "LinearRegression",
    "LinearRegressionModel", "LinearSVC", "LinearSVCModel", "LogisticRegression",
    "LogisticRegressionModel", "MaxAbsScaler", "MaxAbsScalerModel", "MinMaxScaler",
    "MinMaxScalerModel", "MulticlassClassificationEvaluator",
    "MultilayerPerceptronClassificationModel", "MultilayerPerceptronClassifier",
    "NaiveBayes", "NaiveBayesModel", "NearestNeighbors", "NearestNeighborsModel",
    "Normalizer", "OneHotEncoder", "OneHotEncoderModel", "OneVsRest", "OneVsRestModel",
    "PCA", "PCAModel", "ParamGridBuilder", "Pipeline", "PipelineModel",
    "PolynomialExpansion", "QuantileDiscretizer", "QuantileDiscretizerModel",
    "RandomForestClassificationModel", "RandomForestClassifier",
    "RandomForestRegressionModel", "RandomForestRegressor", "RegressionEvaluator",
    "RobustScaler", "RobustScalerModel", "StandardScaler", "StandardScalerModel",
    "StringIndexer", "StringIndexerModel", "Tokenizer", "TrainValidationSplit",
    "TrainValidationSplitModel", "TruncatedSVD", "TruncatedSVDModel", "UMAP", "UMAPModel",
    "VarianceThresholdSelector", "VarianceThresholdSelectorModel", "VectorAssembler",
    "VectorSlicer", "__version__", *_SPARK_NAMES,
]
