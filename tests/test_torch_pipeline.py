"""BASELINE config 4 in the port: ``Pipeline([StandardScaler, PCA])`` and
``Pipeline([Normalizer, PCA])`` against the JAX package's, on the CPU.

The same seeded f32 rows (4,000 × 24, a rank-12 mix with unequal column
scales and means, so the scaler matters) go through both packages'
pipelines. The scaler's statistics agree at rtol 1e-5; the PCA stage's
components to min |cosine| ≥ 0.9999 and its explainedVariance to rtol
1e-5; the transformed rows to 1e-5 × max |out|. Pipelines save in the JAX
package's numbered-stage layout: a JAX save loads in the port, and the
port's stages' arrays read in the JAX package. The pipeline's FitReport
counts the caller's rows once, and only the outermost fit exports.
"""

from __future__ import annotations

import json

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pandas as pd
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.models.pipeline import Pipeline as JaxPipeline
from spark_rapids_ml_tpu.models.scaler import Normalizer as JaxNormalizer
from spark_rapids_ml_tpu.models.scaler import StandardScaler as JaxStandardScaler
from spark_rapids_ml_tpu.models.scaler import StandardScalerModel as JaxStandardScalerModel
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import PCA, Normalizer, Pipeline, PipelineModel, StandardScaler
from spark_rapids_ml_tpu_torch import convert
from spark_rapids_ml_tpu_torch.models.base import Saveable

ROWS, N, K = 4_000, 24, 5
RTOL = 1e-5
COSINE_BAR = 0.9999


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(23)
    base = rng.normal(size=(ROWS, 12)).astype(np.float32)
    mix = rng.normal(size=(12, N)).astype(np.float32)
    scales = rng.uniform(0.2, 5.0, size=N).astype(np.float32)
    shifts = rng.uniform(-3.0, 3.0, size=N).astype(np.float32)
    noise = 0.1 * rng.normal(size=(ROWS, N)).astype(np.float32)
    return ((base @ mix + noise) * scales + shifts).astype(np.float32)


def _min_abs_cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))).min()


def _stages(pkg, first):
    if pkg == "jax":
        pre = (JaxStandardScaler(withMean=True, withStd=True) if first == "scaler"
               else JaxNormalizer(p=2.0))
        return [pre, JaxPCA().setK(K)]
    pre = (StandardScaler(device="cpu", withMean=True, withStd=True) if first == "scaler"
           else Normalizer(device="cpu", p=2.0))
    return [pre, PCA(device="cpu").setK(K)]


def _assert_close(got, expected, rtol=RTOL):
    got, expected = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=rtol, atol=rtol * np.abs(expected).max())


def _assert_pca_agrees(port, ref):
    assert port.pc.shape == ref.pc.shape == (N, K)
    assert _min_abs_cosine(port.pc, ref.pc) >= COSINE_BAR
    _assert_close(port.explainedVariance, ref.explainedVariance)


@pytest.mark.parametrize("first", ["scaler", "normalizer"])
@pytest.mark.parametrize("partitions", [1, 4])
def test_pipeline_into_pca_matches_jax(x, first, partitions):
    """Fit on an ndarray (one partition) or on the port's partitioned
    dataset of 4 partitions (the JAX pipeline gets the same 4 slices as a
    list of matrices through its own dataset)."""
    from spark_rapids_ml_tpu.utils.columnar import PartitionedDataset as JaxDataset
    from spark_rapids_ml_tpu_torch.utils.columnar import PartitionedDataset

    port_data = PartitionedDataset.from_any(x, None, partitions) if partitions > 1 else x
    ref_data = JaxDataset.from_any(x, None, partitions) if partitions > 1 else x
    port = Pipeline(stages=_stages("port", first)).fit(port_data)
    ref = JaxPipeline(stages=_stages("jax", first)).fit(ref_data)
    assert [type(s).__name__ for s in port.stages] == [type(s).__name__ for s in ref.stages]
    if first == "scaler":
        _assert_close(port.stages[0].mean, ref.stages[0].mean)
        _assert_close(port.stages[0].std, ref.stages[0].std)
    _assert_pca_agrees(port.stages[1], ref.stages[1])
    out, expected = port.transform(x), ref.transform(x)
    # both sides orient components by the same sign rule
    _assert_close(out, expected)


def test_pipeline_chains_named_columns_like_jax(x):
    df = pd.DataFrame({"features": list(x)})
    port = Pipeline(stages=[
        StandardScaler(device="cpu", withMean=True).setInputCol("features").setOutputCol("s"),
        PCA(device="cpu").setK(K).setInputCol("s").setOutputCol("p"),
    ]).fit(df)
    ref = JaxPipeline(stages=[
        JaxStandardScaler(withMean=True).setInputCol("features").setOutputCol("s"),
        JaxPCA().setK(K).setInputCol("s").setOutputCol("p"),
    ]).fit(df)
    out, expected = port.transform(df), ref.transform(df)
    assert list(out.columns) == list(expected.columns) == ["features", "s", "p"]
    _assert_close(np.stack(out["p"]), np.stack(expected["p"]))


def test_pipeline_fit_report_counts_the_callers_rows_once(x, tmp_path, monkeypatch):
    sink = tmp_path / "reports.jsonl"
    monkeypatch.setenv("TPU_ML_TELEMETRY_PATH", str(sink))
    model = Pipeline(stages=_stages("port", "scaler")).fit(x)
    report = model.fit_report
    assert report.estimator == "Pipeline" and report.rows_ingested == ROWS
    assert report.bytes_ingested == x.nbytes
    assert {"scaler moments", "scaler transform", "compute cov", "eigh"} <= set(report.phases)
    # each stage has its own report, a sub-window of the pipeline's
    scaler_report, pca_report = (s.fit_report for s in model.stages)
    assert scaler_report.rows_ingested == pca_report.rows_ingested == ROWS
    assert scaler_report.fit_id != pca_report.fit_id != report.fit_id
    assert pca_report.wall_seconds <= report.wall_seconds
    assert report.h2d_bytes == 0  # the CPU: no copy to a card
    lines = [json.loads(line) for line in sink.read_text().splitlines()]
    assert [r["estimator"] for r in lines if r["type"] == "fit_report"] == ["Pipeline"]
    # the stages' transforms inside the fit are transforms of their own
    assert [r["transformer"] for r in lines if r["type"] == "transform_report"] == [
        "StandardScalerModel", "PCAModel"]


@pytest.mark.parametrize("first", ["scaler", "normalizer"])
def test_jax_pipeline_save_loads_in_the_port(x, tmp_path, first):
    ref = JaxPipeline(stages=_stages("jax", first)).fit(x)
    ref.save(str(tmp_path / "m"))
    loaded = PipelineModel.load(str(tmp_path / "m"), device="cpu")
    assert isinstance(loaded, PipelineModel) and loaded.uid == ref.uid
    assert [type(s).__name__ for s in loaded.stages] == [type(s).__name__ for s in ref.stages]
    _assert_close(loaded.transform(x), ref.transform(x))
    # an unfitted pipeline round-trips too, its stages' params kept
    JaxPipeline(stages=_stages("jax", first)).save(str(tmp_path / "e"))
    est = Saveable.load(str(tmp_path / "e"), device="cpu")
    assert isinstance(est, Pipeline) and est.getStages()[1].getK() == K


def test_port_pipeline_save_round_trips_and_crosses_as_arrays(x, tmp_path):
    model = Pipeline(stages=_stages("port", "scaler")).fit(x)
    model.save(str(tmp_path / "m"))
    with pytest.raises(FileExistsError):
        model.save(str(tmp_path / "m"))
    loaded = Saveable.load(str(tmp_path / "m"), device="cpu")
    assert isinstance(loaded, PipelineModel) and loaded.fit_report is None
    np.testing.assert_array_equal(loaded.transform(x), model.transform(x))
    # The JAX classes do not load the port's native save, by design: each
    # stage's save records the port's class, which the JAX load policy
    # refuses (and the JAX PipelineModel.load hands each stage to the
    # class its save records, the port's). The arrays cross.
    with pytest.raises(TypeError, match="not a StandardScalerModel"):
        JaxStandardScalerModel.load(str(tmp_path / "m" / "stage_0"))
    for i, stage in enumerate(model.stages):
        arrays = jax_persistence.load_arrays(str(tmp_path / "m" / f"stage_{i}"))
        for key, arr in stage._saveData().items():
            np.testing.assert_array_equal(arrays[key], arr)
    with pytest.raises(ValueError, match="native layout"):
        model.save(str(tmp_path / "s"), layout="spark")


def test_pipeline_model_carries_across_from_arrays(x):
    ref = JaxPipeline(stages=_stages("jax", "scaler")).fit(x)
    port = convert.pipeline_model_from_arrays(
        [{"class": type(s).__name__, "data": s._saveData(), "params": dict(s._paramMap)}
         for s in ref.stages],
        device="cpu",
    )
    _assert_close(port.transform(x), ref.transform(x))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_instrumented_pca_fit_is_bit_for_bit_the_bare_fit(x, precision):
    """The telemetry wrapper changes nothing the fit computes."""
    pca = PCA(device="cpu").setK(K).setPrecision(precision)
    wrapped = pca.fit(x, num_partitions=3)
    bare = PCA.fit.__wrapped__(pca, x, num_partitions=3)
    np.testing.assert_array_equal(wrapped.pc, bare.pc)
    np.testing.assert_array_equal(wrapped.explainedVariance, bare.explainedVariance)
    assert wrapped.fit_report is not None and bare.fit_report is None
