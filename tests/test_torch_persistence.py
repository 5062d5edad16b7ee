"""Save and load of the port's PCA, and the crossing with the JAX package.

Both of the JAX package's layouts are held to: the native ``metadata.json``
+ ``data.parquet`` and stock Spark ML's ``metadata/part-00000`` + ``data/``
parquet of MatrixUDT/VectorUDT structs. Arrays survive a save bit for bit
(parquet holds them as f64 or their own dtype), so every comparison here is
exact.

- A JAX-package save, in either layout, loads in the port in a process that
  cannot import ``jax``, ``jaxlib`` or ``spark_rapids_ml_tpu``.
- The port's Spark-layout save loads in the JAX package.
- The port's native save does not load in the JAX package: its loader
  admits only its own classes (``_resolve_load_class`` raises
  ``TypeError``), by design. Its ``data.parquet`` reads there all the same.
- The port imports, and says what is missing when asked to save, without
  pyarrow (the card's machine has none).
"""

import json
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.models.pca import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.base import Saveable

REPO = pathlib.Path(__file__).resolve().parents[1]
ROWS, N, K = 400, 24, 4


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(ROWS, 8)).astype(np.float32)
    return base @ rng.normal(size=(8, N)).astype(np.float32) + 0.1 * rng.normal(
        size=(ROWS, N)).astype(np.float32)


def _fit(x, standardize=False):
    return (PCA(device="cpu", standardize=standardize).setInputCol("features")
            .setOutputCol("proj").setK(K).fit(x))


def _assert_same_model(a, b):
    np.testing.assert_array_equal(a.pc, b.pc)
    np.testing.assert_array_equal(a.explainedVariance, b.explainedVariance)
    for name in ("mean", "std"):
        if getattr(b, name) is None:
            assert getattr(a, name) is None
        else:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert a.uid == b.uid


@pytest.mark.parametrize("standardize", [False, True])
def test_native_round_trip(x, tmp_path, standardize):
    model = _fit(x, standardize)
    path = str(tmp_path / "m")
    model.save(path)
    assert (tmp_path / "m" / "metadata.json").exists()
    assert (tmp_path / "m" / "data.parquet").exists()
    meta = json.loads((tmp_path / "m" / "metadata.json").read_text())
    assert meta["class"] == "spark_rapids_ml_tpu_torch.models.pca.PCAModel"
    from spark_rapids_ml_tpu_torch import __version__
    assert meta["libraryVersion"] == __version__
    loaded = PCAModel.load(path, device="cpu")
    _assert_same_model(loaded, model)
    assert loaded.device.type == "cpu" and loaded.getK() == K
    assert loaded.getOutputCol() == "proj" and loaded.getOrDefault("solver") == "full"
    np.testing.assert_array_equal(loaded.transform(x), model.transform(x))
    assert isinstance(Saveable.load(path, device="cpu"), PCAModel)


def test_spark_round_trip(x, tmp_path):
    model = _fit(x)
    path = str(tmp_path / "s")
    model.write().format("spark").save(path)
    assert (tmp_path / "s" / "metadata" / "part-00000").exists()
    assert (tmp_path / "s" / "metadata" / "_SUCCESS").exists()
    assert (tmp_path / "s" / "data" / "_SUCCESS").exists()
    meta = json.loads((tmp_path / "s" / "metadata" / "part-00000").read_text())
    assert meta["class"] == "org.apache.spark.ml.feature.PCAModel"
    assert set(meta["paramMap"]) <= {"k", "inputCol", "outputCol"} and meta["paramMap"]["k"] == K
    loaded = PCAModel.load(path, device="cpu")
    _assert_same_model(loaded, model)
    assert loaded.getInputCol() == "features" and loaded.getOutputCol() == "proj"


def test_spark_layout_refuses_a_standardize_model_and_keeps_the_old_save(x, tmp_path):
    path = str(tmp_path / "s")
    plain = _fit(x)
    plain.write().format("spark").save(path)
    with pytest.raises(NotImplementedError, match="standardize"):
        _fit(x, standardize=True).write().overwrite().format("spark").save(path)
    _assert_same_model(PCAModel.load(path, device="cpu"), plain)


def test_overwrite_semantics(x, tmp_path):
    path = str(tmp_path / "m")
    first, second = _fit(x), _fit(x[: ROWS // 2])
    first.save(path)
    with pytest.raises(FileExistsError, match="overwrite"):
        second.save(path)
    _assert_same_model(PCAModel.load(path, device="cpu"), first)
    second.write().overwrite().save(path)
    _assert_same_model(PCAModel.load(path, device="cpu"), second)
    first.save(path, overwrite=True, layout="spark")
    assert not (tmp_path / "m" / "metadata.json").exists()
    _assert_same_model(PCAModel.load(path, device="cpu"), first)
    second.write().overwrite().format("spark").save(path)
    _assert_same_model(PCAModel.load(path, device="cpu"), second)
    with pytest.raises(ValueError, match="format"):
        first.write().format("orc")
    with pytest.raises(ValueError, match="layout"):
        first.save(path, overwrite=True, layout="orc")


def test_estimator_round_trip(tmp_path):
    pca = PCA(device="cpu").setK(3).setSolver("randomized").setPrecision("default")
    pca.save(str(tmp_path / "e"))
    loaded = PCA.load(str(tmp_path / "e"), device="cpu")
    assert isinstance(loaded, PCA) and loaded.uid == pca.uid
    assert loaded.getK() == 3 and loaded.getOrDefault("solver") == "randomized"
    assert loaded.getOrDefault("precision") == "default"
    assert not (tmp_path / "e" / "data.parquet").exists()


def test_load_refuses_the_other_class(x, tmp_path):
    _fit(x).save(str(tmp_path / "m"))
    with pytest.raises(TypeError, match="PCAModel"):
        PCA.load(str(tmp_path / "m"), device="cpu")


BLOCKED_LOAD = r'''
import json, sys

BLOCKED = ("jax", "jaxlib", "spark_rapids_ml_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
from spark_rapids_ml_tpu_torch import PCA, PCAModel

out = {}
for key, path in json.loads(sys.argv[1]).items():
    loaded = (PCA if key == "estimator" else PCAModel).load(path, device="cpu")
    out[key] = {
        "class": type(loaded).__module__ + "." + type(loaded).__name__,
        "uid": loaded.uid,
        "k": loaded.getOrDefault("k"),
        "pc": None if key == "estimator" else loaded.pc.tolist(),
        "ev": None if key == "estimator" else loaded.explainedVariance.tolist(),
        "mean": None if getattr(loaded, "mean", None) is None else loaded.mean.tolist(),
    }
leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print(json.dumps(out))
'''


def test_jax_saves_load_in_the_port_without_jax(x, tmp_path):
    """Native and Spark-layout saves of the JAX package, loaded in a process
    where jax, jaxlib and spark_rapids_ml_tpu cannot be imported."""
    ref = JaxPCA().setInputCol("features").setK(K).fit(x)
    std_ref = JaxPCA(standardize=True).setInputCol("features").setK(K).fit(x)
    paths = {
        "native": tmp_path / "native",
        "spark": tmp_path / "spark",
        "standardize": tmp_path / "standardize",
        "estimator": tmp_path / "estimator",
    }
    ref.save(str(paths["native"]))
    ref.save(str(paths["spark"]), layout="spark")
    std_ref.save(str(paths["standardize"]))
    JaxPCA().setK(3).setSolver("svd").save(str(paths["estimator"]))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_LOAD, json.dumps({k: str(v) for k, v in paths.items()})],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, model in (("native", ref), ("spark", ref), ("standardize", std_ref)):
        assert out[key]["class"] == "spark_rapids_ml_tpu_torch.models.pca.PCAModel"
        assert out[key]["uid"] == model.uid and out[key]["k"] == K
        np.testing.assert_array_equal(np.asarray(out[key]["pc"]), model.pc)
        np.testing.assert_array_equal(np.asarray(out[key]["ev"]), model.explainedVariance)
    np.testing.assert_array_equal(np.asarray(out["standardize"]["mean"]), std_ref.mean)
    assert out["native"]["mean"] is None
    assert out["estimator"]["class"] == "spark_rapids_ml_tpu_torch.models.pca.PCA"
    assert out["estimator"]["k"] == 3


def test_port_spark_save_loads_in_jax(x, tmp_path):
    model = _fit(x)
    model.write().format("spark").save(str(tmp_path / "s"))
    loaded = JaxPCAModel.load(str(tmp_path / "s"))
    np.testing.assert_array_equal(loaded.pc, model.pc)
    np.testing.assert_array_equal(loaded.explainedVariance, model.explainedVariance)
    assert loaded.uid == model.uid and loaded.getK() == K
    np.testing.assert_allclose(np.asarray(loaded.transform(x)), model.transform(x), rtol=0,
                               atol=1e-5 * np.abs(model.transform(x)).max())


def test_port_native_save_crosses_as_arrays_only(x, tmp_path):
    """The JAX package's ``load`` admits only its own classes, so a port
    native save does not load there (``TypeError``, its design); its arrays
    read there unchanged."""
    model = _fit(x, standardize=True)
    model.save(str(tmp_path / "m"))
    arrays = jax_persistence.load_arrays(str(tmp_path / "m"))
    assert set(arrays) == {"pc", "explainedVariance", "mean", "std"}
    for name, value in arrays.items():
        np.testing.assert_array_equal(value, getattr(model, name))
    with pytest.raises(TypeError):
        JaxPCAModel.load(str(tmp_path / "m"))


def test_unported_jax_class_is_refused_without_import(tmp_path):
    # every saveable class of the JAX package has a port counterpart now; a
    # name of its unported mesh layer (ROADMAP Queue A item 6) stands in
    path = tmp_path / "mesh_kmeans"
    path.mkdir()
    (path / "metadata.json").write_text(json.dumps({
        "class": "spark_rapids_ml_tpu.spark.spmd.MeshKMeansFitFn",
        "uid": "MeshKMeansFitFn_1",
        "paramMap": {}, "defaultParamMap": {},
    }))
    with pytest.raises(TypeError, match="no counterpart"):
        Saveable.load(str(path), device="cpu")


def test_spark_only_params_are_dropped(x, tmp_path):
    path = str(tmp_path / "s")
    _fit(x).write().format("spark").save(path)
    part = tmp_path / "s" / "metadata" / "part-00000"
    meta = json.loads(part.read_text())
    meta["defaultParamMap"]["handleInvalid"] = "error"
    part.write_text(json.dumps(meta))
    loaded = PCAModel.load(path, device="cpu")
    assert "handleInvalid" not in loaded._defaultParamMap


BLOCKED_PYARROW = r'''
import sys

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
import numpy as np
import spark_rapids_ml_tpu_torch
from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.utils import persistence
assert persistence.pa is None
x = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
model = PCA(device="cpu").setK(2).fit(x)
for layout in ("native", "spark"):
    try:
        model.save(sys.argv[1], layout=layout)
    except ImportError as e:
        assert "pyarrow" in str(e), e
    else:
        raise AssertionError("saved without pyarrow")
import os
assert not os.path.exists(sys.argv[1])
print("ok")
'''


def test_package_imports_without_pyarrow(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_PYARROW, str(tmp_path / "m")],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


BLOCKED_LOAD_ANY = r'''
import json, sys

BLOCKED = ("jax", "jaxlib", "spark_rapids_ml_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Blocker())
from spark_rapids_ml_tpu_torch.models.base import Saveable

out = {}
for key, path in json.loads(sys.argv[1]).items():
    loaded = Saveable.load(path, device="cpu")
    out[key] = {
        "class": type(loaded).__module__ + "." + type(loaded).__name__,
        "uid": loaded.uid,
        "params": {k: loaded.getOrDefault(k) for k in loaded._paramMap},
        "arrays": {k: v.tolist() for k, v in loaded._saveData().items()},
    }
leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print(json.dumps(out))
'''


def test_linear_family_saves_cross_both_ways(x, tmp_path):
    """The JAX package's native saves of the linear family, TruncatedSVD and
    an incremental estimator load in the port where jax cannot be imported,
    arrays bit for bit; the port's saves of them read in the JAX package
    (``load_arrays`` and the class's ``_fromSaved``)."""
    from spark_rapids_ml_tpu.models import incremental as JI
    from spark_rapids_ml_tpu.models import linear as JLM
    from spark_rapids_ml_tpu.models.truncated_svd import TruncatedSVD as JaxTSVD

    y = x @ np.linspace(-1, 1, N).astype(np.float32)
    labels = (y > 0).astype(np.float64)
    classes = np.digitize(y, np.quantile(y, [0.33, 0.66])).astype(np.float64)
    refs = {
        "linreg": JLM.LinearRegression().setRegParam(0.1).fit((x, y)),
        "logreg": JLM.LogisticRegression().setRegParam(0.1).fit((x, labels)),
        "softmax": JLM.LogisticRegression().setRegParam(0.1).fit((x, classes)),
        "svc": JLM.LinearSVC().setRegParam(0.1).fit((x, labels)),
        "tsvd": JaxTSVD(k=K).setInputCol("features").fit(x),
        "incremental": JI.IncrementalLinearRegression().setRegParam(0.5),
    }
    paths = {key: tmp_path / key for key in refs}
    for key, model in refs.items():
        model.save(str(paths[key]))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_LOAD_ANY, json.dumps({k: str(v) for k, v in paths.items()})],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, model in refs.items():
        module = type(model).__module__.replace("spark_rapids_ml_tpu.", "spark_rapids_ml_tpu_torch.")
        assert out[key]["class"] == f"{module}.{type(model).__name__}"
        assert out[key]["uid"] == model.uid
        assert out[key]["params"] == {k: model.getOrDefault(k) for k in model._paramMap}
        want = model._saveData()
        assert set(out[key]["arrays"]) == set(want)
        for name, value in want.items():
            np.testing.assert_array_equal(np.asarray(out[key]["arrays"][name]), value)
    # the port's own saves, read back in the JAX package
    for key, model in refs.items():
        if not model._saveData():
            continue
        port = Saveable.load(str(paths[key]), device="cpu")
        port.save(str(tmp_path / f"port-{key}"))
        arrays = jax_persistence.load_arrays(str(tmp_path / f"port-{key}"))
        back = type(model)._fromSaved(None, arrays)
        for name, value in model._saveData().items():
            np.testing.assert_array_equal(np.asarray(back._saveData()[name]), value)


def test_boosting_network_and_manifold_saves_cross_both_ways(x, tmp_path):
    """The JAX package's native saves of GBT, MLP, FM, UMAP and isotonic
    models (and of an estimator of each) load in the port where jax cannot
    be imported, arrays bit for bit and params equal; the port's own saves
    of them read in the JAX package (``load_arrays`` and the class's
    ``_fromSaved``) bit for bit."""
    from spark_rapids_ml_tpu.models import fm as JFM
    from spark_rapids_ml_tpu.models import gbt as JG
    from spark_rapids_ml_tpu.models import isotonic as JI
    from spark_rapids_ml_tpu.models import mlp as JM
    from spark_rapids_ml_tpu.models import umap as JU

    y = x @ np.linspace(-1, 1, N).astype(np.float32)
    labels = (y > 0).astype(np.float64)
    refs = {
        "gbt_classifier": JG.GBTClassifier(numTrees=3, maxDepth=3).fit((x, labels)),
        "gbt_regressor": JG.GBTRegressor(numTrees=3, maxDepth=3, stepSize=0.5).fit((x, y)),
        "mlp": JM.MultilayerPerceptronClassifier(layers=[N, 5, 2], maxIter=5).fit((x, labels)),
        "fm_classifier": JFM.FMClassifier(maxIter=5, stepSize=0.01).fit((x, labels)),
        "fm_regressor": JFM.FMRegressor(maxIter=5, stepSize=0.01, factorSize=3).fit((x, y)),
        "umap": JU.UMAP(nNeighbors=5, nEpochs=5, seed=1).fit(x),
        "isotonic": JI.IsotonicRegression(featureIndex=3, isotonic=False).fit((x, y)),
        "gbt_estimator": JG.GBTRegressor(maxDepth=4).setMaxIter(7),
        "mlp_estimator": JM.MultilayerPerceptronClassifier(layers=[N, 2], solver="gd"),
        "umap_estimator": JU.UMAP(nNeighbors=7),
        "isotonic_estimator": JI.IsotonicRegression(isotonic=False, featureIndex=2),
    }
    paths = {key: tmp_path / key for key in refs}
    for key, model in refs.items():
        model.save(str(paths[key]))
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKED_LOAD_ANY, json.dumps({k: str(v) for k, v in paths.items()})],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for key, model in refs.items():
        module = type(model).__module__.replace("spark_rapids_ml_tpu.", "spark_rapids_ml_tpu_torch.")
        assert out[key]["class"] == f"{module}.{type(model).__name__}"
        assert out[key]["uid"] == model.uid
        assert out[key]["params"] == {k: model.getOrDefault(k) for k in model._paramMap}
        want = model._saveData()
        assert set(out[key]["arrays"]) == set(want)
        for name, value in want.items():
            np.testing.assert_array_equal(np.asarray(out[key]["arrays"][name]), value)
    for key, model in refs.items():
        if not model._saveData():
            continue
        port = Saveable.load(str(paths[key]), device="cpu")
        port.save(str(tmp_path / f"port-{key}"))
        arrays = jax_persistence.load_arrays(str(tmp_path / f"port-{key}"))
        back = type(model)._fromSaved(None, arrays)
        for name, value in model._saveData().items():
            np.testing.assert_array_equal(np.asarray(back._saveData()[name]), value)


def test_one_vs_rest_saves_cross(x, tmp_path):
    """A JAX OneVsRest model (class models in ``class-<c>/``) and estimator
    (template in ``classifier/``) load in the port with their class models
    mapped; the port's saves load back in the port and their class arrays
    read in the JAX package."""
    from spark_rapids_ml_tpu.models import linear as JL
    from spark_rapids_ml_tpu.models import ovr as JO
    from spark_rapids_ml_tpu_torch import LogisticRegression, OneVsRest, OneVsRestModel

    y = x @ np.linspace(-1, 1, N).astype(np.float32)
    classes = np.digitize(y, np.quantile(y, [0.33, 0.66])).astype(np.float64)
    ref = JO.OneVsRest(classifier=JL.LogisticRegression(regParam=0.1)).fit((x, classes))
    ref.save(str(tmp_path / "model"))
    JO.OneVsRest(classifier=JL.LogisticRegression(regParam=0.2)).save(str(tmp_path / "est"))
    for loader in (Saveable.load, OneVsRestModel.load):
        port = loader(str(tmp_path / "model"), device="cpu")
        assert isinstance(port, OneVsRestModel) and port.uid == ref.uid
        np.testing.assert_array_equal(port._predict_matrix(x), ref._predict_matrix(x))
    est = OneVsRest.load(str(tmp_path / "est"), device="cpu")
    assert isinstance(est.getClassifier(), LogisticRegression)
    assert est.getClassifier().getRegParam() == 0.2
    port.save(str(tmp_path / "port-model"))
    again = Saveable.load(str(tmp_path / "port-model"), device="cpu")
    np.testing.assert_array_equal(again._predict_matrix(x), port._predict_matrix(x))
    for c, m in enumerate(ref.models):
        arrays = jax_persistence.load_arrays(str(tmp_path / "port-model" / f"class-{c}"))
        np.testing.assert_array_equal(arrays["coefficients"], m.coefficients)
    est.save(str(tmp_path / "port-est"))
    assert OneVsRest.load(str(tmp_path / "port-est"), device="cpu").getClassifier().uid == \
        est.getClassifier().uid
