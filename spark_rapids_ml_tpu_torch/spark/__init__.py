"""The Spark glue of the port: the streamed fold and the driver chunker
(``ingest``), the Arrow plan functions that run in Spark workers
(``arrow_fns``), and the DataFrame-facing estimators (``estimators``):
every ``Spark*`` class of the JAX package's ``spark`` namespace, on the
``"driver-merge"`` distribution.

The estimators load on first use (``__getattr__``), since they need
pyarrow at run time and the package imports without it."""

_ESTIMATORS = (
    "SparkApproximateNearestNeighbors", "SparkApproximateNearestNeighborsModel",
    "SparkBinarizer", "SparkBucketizer", "SparkDBSCAN", "SparkDBSCANModel", "SparkDCT",
    "SparkElementwiseProduct", "SparkFMClassificationModel", "SparkFMClassifier",
    "SparkFMRegressionModel", "SparkFMRegressor", "SparkGBTClassificationModel",
    "SparkGBTClassifier", "SparkGBTRegressionModel", "SparkGBTRegressor", "SparkImputer",
    "SparkImputerModel", "SparkIsotonicRegression", "SparkIsotonicRegressionModel",
    "SparkKMeans", "SparkKMeansModel", "SparkLinearRegression",
    "SparkLinearRegressionModel", "SparkLinearSVC", "SparkLinearSVCModel",
    "SparkLogisticRegression", "SparkLogisticRegressionModel", "SparkMaxAbsScaler",
    "SparkMaxAbsScalerModel", "SparkMinMaxScaler", "SparkMinMaxScalerModel",
    "SparkMultilayerPerceptronClassificationModel", "SparkMultilayerPerceptronClassifier",
    "SparkNaiveBayes", "SparkNaiveBayesModel", "SparkNearestNeighbors",
    "SparkNearestNeighborsModel", "SparkNormalizer", "SparkOneVsRest",
    "SparkOneVsRestModel", "SparkPCA", "SparkPCAModel", "SparkPolynomialExpansion",
    "SparkQuantileDiscretizer", "SparkQuantileDiscretizerModel",
    "SparkRandomForestClassificationModel", "SparkRandomForestClassifier",
    "SparkRandomForestRegressionModel", "SparkRandomForestRegressor", "SparkRobustScaler",
    "SparkRobustScalerModel", "SparkStandardScaler", "SparkStandardScalerModel",
    "SparkTruncatedSVD", "SparkTruncatedSVDModel", "SparkUMAP", "SparkUMAPModel",
    "SparkVarianceThresholdSelector", "SparkVarianceThresholdSelectorModel",
    "SparkVectorSlicer",
)

__all__ = ["arrow_fns", "ingest", *_ESTIMATORS]


def __getattr__(name: str):
    import importlib

    if name in ("arrow_fns", "ingest", "estimators"):
        return importlib.import_module(f"{__name__}.{name}")
    if name in _ESTIMATORS:
        return getattr(importlib.import_module(f"{__name__}.estimators"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
