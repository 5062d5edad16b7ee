"""The port's column stages against the JAX package's.

VectorAssembler, StringIndexer (its four orders and Spark's tie rule, its
model's ``handleInvalid``), OneHotEncoder (``dropLast``, ``handleInvalid``)
and IndexToString run on the same seeded pandas frame in both packages; the
outputs are bit-equal (both sides are the same numpy arithmetic). The two
models cross between the packages as arrays (``_saveData``) and as native
saves, and a raw-columns pipeline ends in the port's StandardScaler on the
CPU, held to the JAX pipeline's to 1e-12.
"""

import jax  # noqa: F401
import numpy as np
import pytest

from spark_rapids_ml_tpu.models import feature_eng as JF
from spark_rapids_ml_tpu.models.pipeline import Pipeline as JPipeline
from spark_rapids_ml_tpu.models.scaler import StandardScaler as JStandardScaler
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import convert
from spark_rapids_ml_tpu_torch.models import feature_eng as PF
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.models.pipeline import Pipeline
from spark_rapids_ml_tpu_torch.models.scaler import StandardScaler

pd = pytest.importorskip("pandas")

ORDERS = ("frequencyDesc", "frequencyAsc", "alphabetAsc", "alphabetDesc")


@pytest.fixture()
def df():
    rng = np.random.default_rng(5)
    rows = 40
    # "b" and "c" tie on frequency: Spark breaks the tie alphabetically
    city = np.array(["a"] * 12 + ["b"] * 9 + ["c"] * 9 + ["d"] * 6 + ["?"] * 4)
    rng.shuffle(city)
    return pd.DataFrame({
        "age": rng.uniform(20, 60, size=rows),
        "income": rng.uniform(1e4, 1e5, size=rows),
        "scores": list(rng.normal(size=(rows, 3))),
        "city": city,
        "hours": rng.integers(1, 99, size=rows).astype(np.float64),
    })


def _col(out, name):
    v = out[name].to_numpy()
    return np.stack(v) if v.dtype == object and np.ndim(v[0]) else v


@pytest.mark.parametrize("handle", ["error", "keep"])
def test_vector_assembler_matches_jax(df, handle):
    cols = ["age", "scores", "income", "hours"]
    p = PF.VectorAssembler(handleInvalid=handle).setInputCols(cols).transform(df)
    j = JF.VectorAssembler().setHandleInvalid(handle).setInputCols(cols).transform(df)
    np.testing.assert_array_equal(_col(p, "features"), _col(j, "features"))
    bad = df.copy()
    bad.loc[3, "age"] = np.nan
    bad.loc[4, "income"] = np.inf  # a legal Double
    if handle == "error":
        for mod in (PF, JF):
            with pytest.raises(ValueError, match=r"NaN in columns \['age'\]"):
                mod.VectorAssembler().setInputCols(cols).transform(bad)
    else:
        p = PF.VectorAssembler(handleInvalid="keep").setInputCols(cols).transform(bad)
        j = JF.VectorAssembler().setHandleInvalid("keep").setInputCols(cols).transform(bad)
        np.testing.assert_array_equal(_col(p, "features"), _col(j, "features"))


@pytest.mark.parametrize("order", ORDERS)
def test_string_indexer_orders_match_jax(df, order):
    p = PF.StringIndexer(stringOrderType=order).setInputCol("city").setOutputCol("ci").fit(df)
    j = JF.StringIndexer().setStringOrderType(order).setInputCol("city").setOutputCol("ci").fit(df)
    assert p.labels == j.labels
    if order == "frequencyDesc":
        assert p.labels == ["a", "b", "c", "d", "?"]
    np.testing.assert_array_equal(_col(p.transform(df), "ci"), _col(j.transform(df), "ci"))


def test_unseen_labels_follow_handle_invalid_like_jax(df):
    p = PF.StringIndexer().setInputCol("city").setOutputCol("ci").fit(df)
    j = JF.StringIndexer().setInputCol("city").setOutputCol("ci").fit(df)
    new = pd.DataFrame({"city": ["a", "zz", "d"]})
    for m in (p, j):
        with pytest.raises(ValueError, match="unseen label 'zz'"):
            m.transform(new)
    np.testing.assert_array_equal(
        _col(p.setHandleInvalid("keep").transform(new), "ci"),
        _col(j.setHandleInvalid("keep").transform(new), "ci"))
    for mod in (PF, JF):
        with pytest.raises(ValueError, match="stringOrderType must be one of"):
            mod.StringIndexer().setStringOrderType("random")


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("handle", ["error", "keep"])
def test_one_hot_encoder_matches_jax(df, drop_last, handle):
    indexed = JF.StringIndexer().setInputCol("city").setOutputCol("ci").fit(df).transform(df)
    p = PF.OneHotEncoder(dropLast=drop_last, handleInvalid=handle).setInputCol(
        "ci").setOutputCol("v").fit(indexed)
    j = JF.OneHotEncoder().setDropLast(drop_last).setHandleInvalid(handle).setInputCol(
        "ci").setOutputCol("v").fit(indexed)
    assert p.categorySize == j.categorySize == 5
    np.testing.assert_array_equal(_col(p.transform(indexed), "v"), _col(j.transform(indexed), "v"))
    out_of_range = pd.DataFrame({"ci": [0.0, 7.0, 4.0]})
    if handle == "error":
        for m in (p, j):
            with pytest.raises(ValueError, match="outside"):
                m.transform(out_of_range)
    else:
        np.testing.assert_array_equal(_col(p.transform(out_of_range), "v"),
                                      _col(j.transform(out_of_range), "v"))
    for mod in (PF, JF):
        with pytest.raises(ValueError, match="non-negative integer"):
            mod.OneHotEncoder().setInputCol("ci").fit(pd.DataFrame({"ci": [0.0, 1.5]}))


def test_index_to_string_matches_jax(df):
    si = JF.StringIndexer().setInputCol("city").setOutputCol("ci").fit(df)
    indexed = si.transform(df)
    p = PF.IndexToString().setInputCol("ci").setOutputCol("c2").setLabels(si.labels)
    j = JF.IndexToString().setInputCol("ci").setOutputCol("c2").setLabels(si.labels)
    assert list(p.transform(indexed)["c2"]) == list(j.transform(indexed)["c2"]) == list(df["city"])
    for mod in (PF, JF):
        with pytest.raises(ValueError, match="outside the label table"):
            mod.IndexToString().setInputCol("ci").setLabels(["x"]).transform(indexed)
        with pytest.raises(ValueError, match="setLabels"):
            mod.IndexToString().setInputCol("ci").transform(indexed)


def test_models_cross_as_arrays_and_saves(df, tmp_path):
    jsi = JF.StringIndexer().setInputCol("city").setOutputCol("ci").fit(
        pd.DataFrame({"city": ["münchen", "nyc", "münchen", "køge"]}))
    indexed = jsi.transform(pd.DataFrame({"city": ["nyc", "køge"]}))
    johe = JF.OneHotEncoder().setInputCol("ci").setOutputCol("v").setDropLast(False).fit(
        jsi.transform(pd.DataFrame({"city": ["münchen", "nyc", "køge"]})))
    for jm, name in ((jsi, "StringIndexerModel"), (johe, "OneHotEncoderModel")):
        # the JAX model's arrays into the port, and the port's back
        pm = convert.model_from_arrays(name, jm._saveData(), device="cpu",
                                       params=dict(jm._paramMap))
        back = type(jm)._fromSaved("u", pm._saveData())
        back._paramMap.update(jm._paramMap)
        for m in (pm, back):
            src = indexed if name == "OneHotEncoderModel" else pd.DataFrame({"city": ["nyc", "køge"]})
            out = "v" if name == "OneHotEncoderModel" else "ci"
            np.testing.assert_array_equal(_col(m.transform(src), out), _col(jm.transform(src), out))
        # a JAX save loads in the port; the port's save's arrays load in JAX
        jm.save(str(tmp_path / f"j{name}"))
        loaded = Saveable.load(str(tmp_path / f"j{name}"), device="cpu")
        assert type(loaded).__name__ == name and loaded.getOutputCol() == jm.getOutputCol()
        assert loaded._saveData().keys() == jm._saveData().keys()
        pm.save(str(tmp_path / f"p{name}"))
        arrays = jax_persistence.load_arrays(str(tmp_path / f"p{name}"))
        again = type(jm)._fromSaved("u", arrays)
        if name == "StringIndexerModel":
            assert loaded.labels == again.labels == jm.labels == ["münchen", "køge", "nyc"]
        else:
            assert loaded.categorySize == again.categorySize == jm.categorySize == 3
    # a stage without arrays (an estimator) loads too
    PF.StringIndexer(stringOrderType="alphabetAsc").setInputCol("c").save(str(tmp_path / "e"))
    assert Saveable.load(str(tmp_path / "e"), device="cpu").getOrDefault(
        "stringOrderType") == "alphabetAsc"


def test_raw_columns_pipeline_matches_jax(df):
    def stages(mod, scaler):
        return [
            mod.StringIndexer().setInputCol("city").setOutputCol("ci"),
            mod.OneHotEncoder().setInputCol("ci").setOutputCol("cityv"),
            mod.VectorAssembler().setInputCols(["age", "income", "cityv", "scores"])
            .setOutputCol("features"),
            scaler.setInputCol("features").setOutputCol("scaled").setWithMean(True),
        ]

    p = Pipeline(stages=stages(PF, StandardScaler(device="cpu"))).fit(df).transform(df)
    j = JPipeline(stages=stages(JF, JStandardScaler())).fit(df).transform(df)
    np.testing.assert_array_equal(_col(p, "features"), _col(j, "features"))
    assert _col(p, "scaled").shape == (len(df), 9)  # 2 + (5 - 1) + 3
    # the port scales in f32 on its device; both against the f64 features
    np.testing.assert_allclose(_col(p, "scaled"), _col(j, "scaled"), rtol=1e-5, atol=1e-5)
