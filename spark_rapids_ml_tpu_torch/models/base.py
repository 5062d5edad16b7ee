"""Estimator / Transformer / Model bases of the port: fit and transform
telemetry, save and load.

Counterpart of ``spark_rapids_ml_tpu/models/base.py``.

**Telemetry.** ``Estimator.__init_subclass__`` wraps every subclass's own
``fit`` (``_instrumented_fit``) and ``Transformer.__init_subclass__`` every
``transform`` (``_instrumented_transform``): each call opens a capture
window (``telemetry/report.py``), and the fitted model gets its
``fit_report``, the transformer its ``transform_report``. A per-thread
depth makes only the outermost call export its report and timeline to the
JSONL sinks, so a pipeline's fit is one line. The wrappers change nothing
in the body they wrap: the same arguments, the same result.

**Persistence** writes the JAX package's two layouts
(``utils/persistence.py``): the native ``metadata.json`` + ``data.parquet``
and ``layout="spark"``, stock Spark ML's shape. ``load`` tells them apart.

What crosses between the packages:

- a JAX-package save loads here in either layout. A native save names its
  class, and a ``spark_rapids_ml_tpu.*`` name resolves to the port's
  counterpart through ``_JAX_CLASSES`` (``spark.estimators.SparkPCAModel``
  included); that module is never imported;
- a Spark-layout save of the port loads in the JAX package and in Spark;
- a native save of the port does not load in the JAX package, whose load
  admits only its own classes; its ``data.parquet`` reads there all the
  same (``load_arrays``).

Loading runs on the host; the loaded stage runs on ``device`` (default
``"cuda"``), as every entry point of the port does.
"""

from __future__ import annotations

import functools
import importlib
import threading
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch import telemetry
from spark_rapids_ml_tpu_torch.models.params import HasDevice, Params
from spark_rapids_ml_tpu_torch.utils import columnar, persistence

_PORT_MODELS = "spark_rapids_ml_tpu_torch.models"

# Stock Spark ML class name -> the port's class, for Spark-layout saves.
_SPARK_ML_CLASSES: dict[str, str] = {
    f"org.apache.spark.ml.feature.{name}": f"{_PORT_MODELS}.{module}.{name}"
    for module, name in (
        ("pca", "PCAModel"),
        ("scaler", "StandardScalerModel"),
        ("scaler", "MinMaxScalerModel"),
        ("scaler", "MaxAbsScalerModel"),
        ("scaler", "RobustScalerModel"),
        ("selector", "VarianceThresholdSelectorModel"),
    )
}

# The port's classes by module, relative to the package. A JAX-package class
# recorded in a native save maps to the port's counterpart, which has the
# same module and class name.
_JAX_PACKAGE = "spark_rapids_ml_tpu"
_PORT_PACKAGE = "spark_rapids_ml_tpu_torch"
_PORTED_CLASSES: dict[str, tuple[str, ...]] = {
    "models.pca": ("PCA", "PCAModel"),
    "models.scaler": (
        "StandardScaler", "StandardScalerModel", "MinMaxScaler", "MinMaxScalerModel",
        "MaxAbsScaler", "MaxAbsScalerModel", "Normalizer", "Binarizer", "RobustScaler",
        "RobustScalerModel", "Imputer", "ImputerModel", "ElementwiseProduct", "VectorSlicer",
        "DCT", "PolynomialExpansion",
    ),
    "models.pipeline": ("Pipeline", "PipelineModel"),
    "models.discretizer": ("Bucketizer", "QuantileDiscretizer", "QuantileDiscretizerModel"),
    "models.selector": ("VarianceThresholdSelector", "VarianceThresholdSelectorModel"),
    "models.kmeans": ("KMeans", "KMeansModel"),
    "models.dbscan": ("DBSCAN", "DBSCANModel"),
    "models.neighbors": (
        "NearestNeighbors", "NearestNeighborsModel", "ApproximateNearestNeighbors",
        "ApproximateNearestNeighborsModel",
    ),
    "models.linear": (
        "LinearRegression", "LinearRegressionModel", "LogisticRegression",
        "LogisticRegressionModel", "LinearSVC", "LinearSVCModel",
    ),
    "models.truncated_svd": ("TruncatedSVD", "TruncatedSVDModel"),
    "models.incremental": (
        "IncrementalPCA", "IncrementalTruncatedSVD", "IncrementalStandardScaler",
        "IncrementalLinearRegression", "IncrementalKMeans",
    ),
    "models.forest": (
        "RandomForestClassifier", "RandomForestClassificationModel",
        "RandomForestRegressor", "RandomForestRegressionModel",
        "DecisionTreeClassifier", "DecisionTreeClassificationModel",
        "DecisionTreeRegressor", "DecisionTreeRegressionModel",
    ),
    "models.naive_bayes": ("NaiveBayes", "NaiveBayesModel"),
    "models.gbt": ("GBTClassifier", "GBTClassificationModel", "GBTRegressor", "GBTRegressionModel"),
    "models.mlp": ("MultilayerPerceptronClassifier", "MultilayerPerceptronClassificationModel"),
    "models.fm": ("FMClassifier", "FMClassificationModel", "FMRegressor", "FMRegressionModel"),
    "models.umap": ("UMAP", "UMAPModel"),
    "models.ovr": ("OneVsRest", "OneVsRestModel"),
    "models.isotonic": ("IsotonicRegression", "IsotonicRegressionModel"),
    "models.feature_eng": (
        "VectorAssembler", "StringIndexer", "StringIndexerModel", "OneHotEncoder",
        "OneHotEncoderModel", "IndexToString",
    ),
    "models.text": ("Tokenizer", "HashingTF", "IDF", "IDFModel"),
    "models.tuning": (
        "CrossValidator", "CrossValidatorModel", "TrainValidationSplit",
        "TrainValidationSplitModel",
    ),
    "ann.index": ("IVFFlatIndex", "IVFFlatIndexModel"),
    "spark.estimators": (
        "SparkApproximateNearestNeighbors", "SparkApproximateNearestNeighborsModel",
        "SparkBinarizer", "SparkBucketizer", "SparkDBSCAN", "SparkDBSCANModel", "SparkDCT",
        "SparkElementwiseProduct", "SparkFMClassificationModel", "SparkFMClassifier",
        "SparkFMRegressionModel", "SparkFMRegressor", "SparkGBTClassificationModel",
        "SparkGBTClassifier", "SparkGBTRegressionModel", "SparkGBTRegressor",
        "SparkImputer", "SparkImputerModel", "SparkIsotonicRegression",
        "SparkIsotonicRegressionModel", "SparkKMeans", "SparkKMeansModel",
        "SparkLinearRegression", "SparkLinearRegressionModel", "SparkLinearSVC",
        "SparkLinearSVCModel", "SparkLogisticRegression", "SparkLogisticRegressionModel",
        "SparkMaxAbsScaler", "SparkMaxAbsScalerModel", "SparkMinMaxScaler",
        "SparkMinMaxScalerModel", "SparkMultilayerPerceptronClassificationModel",
        "SparkMultilayerPerceptronClassifier", "SparkNaiveBayes", "SparkNaiveBayesModel",
        "SparkNearestNeighbors", "SparkNearestNeighborsModel", "SparkNormalizer",
        "SparkOneVsRest", "SparkOneVsRestModel", "SparkPCA", "SparkPCAModel",
        "SparkPolynomialExpansion", "SparkQuantileDiscretizer",
        "SparkQuantileDiscretizerModel", "SparkRandomForestClassificationModel",
        "SparkRandomForestClassifier", "SparkRandomForestRegressionModel",
        "SparkRandomForestRegressor", "SparkRobustScaler", "SparkRobustScalerModel",
        "SparkStandardScaler", "SparkStandardScalerModel", "SparkTruncatedSVD",
        "SparkTruncatedSVDModel", "SparkUMAP", "SparkUMAPModel",
        "SparkVarianceThresholdSelector", "SparkVarianceThresholdSelectorModel",
        "SparkVectorSlicer",
    ),
}
_PORT_CLASS_PATHS: dict[str, str] = {
    name: f"{module}.{name}" for module, names in _PORTED_CLASSES.items() for name in names
}
_JAX_CLASSES: dict[str, str] = {
    f"{_JAX_PACKAGE}.{path}": f"{_PORT_PACKAGE}.{path}"
    for path in _PORT_CLASS_PATHS.values()
}


def _import_class(name: str):
    module, _, qualname = name.rpartition(".")
    return getattr(importlib.import_module(module), qualname)


def port_class(name: str):
    """The port's class of a bare class name (``"StandardScalerModel"``)."""
    path = _PORT_CLASS_PATHS.get(name)
    if path is None:
        raise KeyError(f"the port has no {name!r} (ported: {sorted(_PORT_CLASS_PATHS)})")
    return _import_class(f"{_PORT_PACKAGE}.{path}")


def _native_class(recorded: str, path: str):
    """The class a native save names: a JAX-package name through
    ``_JAX_CLASSES`` (never imported), any other name imported as the JAX
    package's loader does."""
    if recorded.split(".", 1)[0] == _JAX_PACKAGE:
        target = _JAX_CLASSES.get(recorded)
        if target is None:
            raise TypeError(
                f"{path} holds a JAX-package {recorded!r}, which has no "
                f"counterpart in the port yet (ported: {sorted(_JAX_CLASSES)})"
            )
        return _import_class(target)
    return _import_class(recorded)


def _resolve_load_class(cls, klass, path: str):
    """The load-time class policy of both layouts: the recorded (or mapped)
    class wins when it satisfies the caller; a caller that is a subclass of
    it upgrades the load; anything else is a mismatch. ``Saveable`` itself
    accepts everything."""
    if cls is Saveable or issubclass(klass, cls):
        return klass
    if issubclass(cls, klass):
        return cls
    raise TypeError(f"{path} holds a {klass.__name__}, not a {cls.__name__}")


class MLWriter:
    """Spark-style fluent writer: ``model.write().overwrite().save(path)``,
    and ``model.write().format("spark").save(path)`` for the Spark layout."""

    def __init__(self, instance: "Saveable"):
        self._instance = instance
        self._overwrite = False
        self._layout = "native"

    def overwrite(self) -> "MLWriter":
        self._overwrite = True
        return self

    def format(self, layout: str) -> "MLWriter":
        if layout not in ("native", "spark"):
            raise ValueError("format must be 'native' or 'spark'")
        self._layout = layout
        return self

    def save(self, path: str) -> None:
        self._instance.save(path, overwrite=self._overwrite, layout=self._layout)


class Saveable(Params):
    """DefaultParamsWritable/Readable analog. Models override
    ``_saveData``/``_fromSaved`` for their arrays, and
    ``_saveSparkML``/``_fromSparkML`` where stock Spark ML has a twin."""

    def save(self, path: str, overwrite: bool = False, layout: str = "native") -> None:
        # everything is checked before the filesystem is touched: an
        # overwrite never deletes the old save and then fails to write
        if layout not in ("native", "spark"):
            raise ValueError("layout must be 'native' or 'spark'")
        if layout == "spark":
            self._checkSparkML()
            if type(self)._saveSparkML is Saveable._saveSparkML:
                raise NotImplementedError(
                    f"{type(self).__name__} has no stock Spark ML twin; use the native layout"
                )
        data = self._saveData() if layout == "native" else {}
        if layout == "spark" or data:
            persistence._require_pyarrow()
        fs = persistence._FS(path)
        if fs.exists():
            if not overwrite:
                raise FileExistsError(
                    f"{path} already exists (use overwrite=True or write().overwrite())"
                )
            fs.rmtree()
        if layout == "spark":
            self._saveSparkML(path)
            return
        persistence.save_metadata(path, self)
        if data:
            persistence.save_arrays(path, data)

    def write(self) -> MLWriter:
        return MLWriter(self)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {}

    def _checkSparkML(self) -> None:
        """Raise where this instance's state has no Spark ML form."""

    def _saveSparkML(self, path: str) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} has no stock Spark ML twin; use the native layout"
        )

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> Any:
        """The stage saved at ``path``, in either layout, on ``device``."""
        if persistence.is_spark_ml_layout(path):
            return cls._load_spark_layout(path, device)
        meta = persistence.load_metadata(path)
        klass = _resolve_load_class(cls, _native_class(meta["class"], path), path)
        instance = klass._loadNative(path, meta, device)
        instance._restoreParamState(meta)
        return instance

    @classmethod
    def _loadNative(cls, path: str, meta: dict, device: str | torch.device) -> Any:
        """The instance a native save at ``path`` holds, before its params
        are restored: its ``data.parquet`` arrays through ``_fromSaved``.
        A pipeline overrides it to load its stages."""
        data = {}
        if persistence._FS(path).exists("data.parquet"):
            data = persistence.load_arrays(path)
        return cls._fromSaved(meta["uid"], data, device)

    @classmethod
    def _load_spark_layout(cls, path: str, device: str | torch.device) -> Any:
        meta = persistence.load_spark_ml_metadata(path)
        spark_class = meta.get("class", "")
        target = _SPARK_ML_CLASSES.get(spark_class)
        if target is None:
            raise TypeError(
                f"{path} holds a Spark ML {spark_class!r} save with no mapped "
                f"implementation here (mapped: {sorted(_SPARK_ML_CLASSES)})"
            )
        klass = _resolve_load_class(cls, _import_class(target), path)
        instance = klass._fromSparkML(meta, persistence.load_spark_ml_data(path), device)
        _restore_spark_params(instance, meta)
        return instance

    @classmethod
    def _fromSaved(cls, uid: str, data: dict[str, np.ndarray], device: str | torch.device):
        # a host stage (no HasDevice) takes no device
        return cls(uid=uid, device=device) if issubclass(cls, HasDevice) else cls(uid=uid)

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device: str | torch.device) -> Any:
        raise NotImplementedError


def _restore_spark_params(instance: Params, meta: dict) -> None:
    """Apply a Spark-layout metadata's param maps onto ``instance``, keeping
    only the param names it knows (Spark-only params have no effect here)."""
    known = {p.name for p in type(instance).params()}
    for k, v in meta.get("defaultParamMap", {}).items():
        if k in known:
            instance._defaultParamMap[k] = v
    for k, v in meta.get("paramMap", {}).items():
        if k in known:
            instance._paramMap[k] = v


def spark_set_params(instance: Params) -> dict:
    """The explicitly set params of ``instance``, JSON-shaped: what a
    Spark-layout save records in ``paramMap``."""
    return {k: persistence._jsonable(v) for k, v in instance._paramMap.items()}


# Nesting depth of fits and transforms per thread (a pipeline's stages run
# inside its fit): every level gets a report, only the outermost exports.
_fit_depth = threading.local()
_transform_depth = threading.local()


def _dataset_arg(args: tuple, kwargs: dict) -> Any:
    return args[0] if args else kwargs.get("dataset")


def _instrumented_fit(fit):
    """Wrap one class's ``fit`` in a fit window (``telemetry.begin_fit`` /
    ``end_fit``); the model gets the ``FitReport`` as ``fit_report``."""

    @functools.wraps(fit)
    def fit_with_telemetry(self, *args, **kwargs):
        depth = getattr(_fit_depth, "value", 0)
        _fit_depth.value = depth + 1
        dataset = _dataset_arg(args, kwargs)
        rows, nbytes = columnar.dataset_size(dataset)
        degradable = getattr(self, "_degradable", None)
        try:
            cap = telemetry.begin_fit(
                type(self).__name__, getattr(self, "uid", "") or "",
                rows=rows, nbytes=nbytes, device=getattr(self, "device", None),
                outermost=depth == 0,
                degradable=bool(degradable is not None and degradable(dataset)),
            )
        except BaseException:
            # a refused fit must not leave the depth raised, or every later
            # fit of this thread would count as nested and never export
            _fit_depth.value = depth
            raise
        try:
            model = fit(self, *args, **kwargs)
        finally:
            _fit_depth.value = depth
            report = telemetry.end_fit(cap)
        telemetry.attach_report(model, report)
        if depth == 0:
            telemetry.export_fit_report(report)
            telemetry.export_timeline(
                telemetry.TIMELINE.events(since_seq=cap.tl_seq),
                fit_id=report.fit_id, estimator=report.estimator, uid=report.uid,
                overlap_fraction=report.overlap_fraction,
            )
        return model

    fit_with_telemetry._telemetry_wrapped = True
    return fit_with_telemetry


def _is_lazy_plan(out: Any) -> bool:
    """A ``localspark`` DataFrame: a plan whose partition generator
    (``_parts``) runs at action time and can be re-pointed."""
    return callable(getattr(out, "_parts", None)) and hasattr(out, "_derive")


def _defer_transform_finalize(df: Any, cap, finalize) -> None:
    """Run ``finalize`` when ``df`` first materializes: its ``_parts``
    generator is re-pointed to one that sets the transform id around the
    plan's execution (so merged worker telemetry and log records carry it)
    and closes the window when the plan is exhausted. Frames derived from
    ``df`` read ``df._parts`` when they run, so they go through it too."""
    orig = df._parts

    def parts_with_capture():
        token = telemetry.spans.set_current_transform_id(cap.window_id)
        try:
            yield from orig()
        finally:
            try:
                telemetry.spans.reset_current_transform_id(token)
            except ValueError:  # reset from another context
                pass
            finalize()

    df._parts = parts_with_capture


def _instrumented_transform(transform):
    """Wrap one class's ``transform`` in a transform window; the
    transformer gets the ``TransformReport`` as ``transform_report``. An
    eager result closes the window at return; a lazy ``localspark`` plan
    at its first materialization (``_defer_transform_finalize``), so its
    report holds the partitions' work."""

    @functools.wraps(transform)
    def transform_with_telemetry(self, *args, **kwargs):
        depth = getattr(_transform_depth, "value", 0)
        _transform_depth.value = depth + 1
        rows, nbytes = columnar.dataset_size(_dataset_arg(args, kwargs))
        cap = telemetry.begin_transform(
            type(self).__name__, getattr(self, "uid", "") or "", rows=rows, nbytes=nbytes
        )
        done = False

        def finalize():
            nonlocal done
            if done:
                return
            done = True
            report = telemetry.end_transform(cap)
            telemetry.attach_transform_report(self, report)
            if depth == 0:
                telemetry.export_transform_report(report)
                telemetry.export_timeline(
                    telemetry.TIMELINE.events(since_seq=cap.tl_seq),
                    transform_id=report.transform_id, estimator=report.transformer,
                    uid=report.uid,
                )

        try:
            out = transform(self, *args, **kwargs)
        except BaseException:
            _transform_depth.value = depth
            finalize()
            raise
        _transform_depth.value = depth
        if depth == 0 and _is_lazy_plan(out):
            # the window stays open until the plan runs; this context's
            # variables are restored now
            telemetry.release_transform_context(cap)
            _defer_transform_finalize(out, cap, finalize)
        else:
            finalize()
        return out

    transform_with_telemetry._telemetry_wrapped = True
    return transform_with_telemetry


class Transformer(Saveable):
    """A pipeline stage with ``transform``. ``transform_report`` is the
    ``TransformReport`` of this instance's last transform (None before)."""

    transform_report = None

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        transform = cls.__dict__.get("transform")
        if transform is not None and not getattr(transform, "_telemetry_wrapped", False):
            cls.transform = _instrumented_transform(transform)

    def transform(self, dataset: Any) -> Any:
        raise NotImplementedError


class Estimator(Saveable):
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fit = cls.__dict__.get("fit")
        if fit is not None and not getattr(fit, "_telemetry_wrapped", False):
            cls.fit = _instrumented_fit(fit)

    def fit(self, dataset: Any) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer made by an Estimator. ``fit_report`` is the
    ``FitReport`` of the fit that made it; None on a loaded model (a report
    describes a fit, not a file)."""

    fit_report = None
