"""The port's text stages against the JAX package's.

Tokenizer, HashingTF (counts and ``binary``) and IDF run on the same seeded
corpus in both packages. HashingTF's buckets are the JAX package's md5
buckets bit for bit, at power-of-2 and other ``numFeatures``; the matrices
are bit-equal (small integer counts, exact in f64 in any order) and equal
to an independent ``hashlib`` + ``collections.Counter`` construction. IDF
and its transform match at rtol 1e-12 (the same numpy formula), with
``minDocFreq``; IDFModel crosses as arrays and saves.
"""

import collections
import hashlib

import jax  # noqa: F401
import numpy as np
import pytest

from spark_rapids_ml_tpu.models import text as JT
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import convert
from spark_rapids_ml_tpu_torch.models import text as PT
from spark_rapids_ml_tpu_torch.models.base import Saveable

pd = pytest.importorskip("pandas")

WORDS = np.array(["tpu", "kernels", "Fast", "spark", "pipelines", "on", "gpu", "hopper",
                  "wgmma", "tma", "ring", "über", "naïve", "x"])


@pytest.fixture(scope="module")
def docs():
    rng = np.random.default_rng(8)
    # equal token counts: the JAX package stacks a pandas token column
    return pd.DataFrame({"text": [
        " ".join(rng.choice(WORDS, size=6)) for _ in range(30)
    ]})


def _tf(mod, docs, nf, binary=False):
    words = mod.Tokenizer().setInputCol("text").setOutputCol("words").transform(docs)
    tf = (mod.HashingTF().setInputCol("words").setOutputCol("tf").setNumFeatures(nf)
          .setBinary(binary).transform(words))
    return words, np.stack(tf["tf"]), tf


def _counter_tf(texts, nf):
    """An independent construction: hashlib per token, Counter per doc."""
    out = np.zeros((len(texts), nf))
    for i, t in enumerate(texts):
        for term, c in collections.Counter(t.lower().split()).items():
            j = int.from_bytes(hashlib.md5(term.encode("utf-8")).digest()[:8], "little") % nf
            out[i, j] += c
    return out


@pytest.mark.parametrize("nf", [1 << 4, 1 << 10, 97, 1000])
def test_buckets_and_counts_match_jax_bit_for_bit(docs, nf):
    terms = sorted({w.lower() for w in WORDS}) + ["", "ünïcödé", "a" * 300]
    assert [PT._bucket(t, nf) for t in terms] == [JT._bucket(t, nf) for t in terms]
    pw, pm, _ = _tf(PT, docs, nf)
    jw, jm, _ = _tf(JT, docs, nf)
    assert [list(a) for a in pw["words"]] == [list(b) for b in jw["words"]]
    np.testing.assert_array_equal(pm, jm)
    np.testing.assert_array_equal(pm, _counter_tf(list(docs["text"]), nf))
    np.testing.assert_array_equal(_tf(PT, docs, nf, True)[1], _tf(JT, docs, nf, True)[1])


def test_documents_of_any_length(docs):
    """Token lists of different lengths hash in the port; the JAX package
    stacks a pandas token column into a matrix and refuses them (ROADMAP
    Queue C)."""
    ragged = pd.DataFrame({"text": ["a b c a", "b", "", "Hello world a b c d"]})
    _, m, _ = _tf(PT, ragged, 64)
    np.testing.assert_array_equal(m, _counter_tf(list(ragged["text"]), 64))
    with pytest.raises(ValueError, match="same shape"):
        _tf(JT, ragged, 64)


def test_refusals_match_jax(docs):
    big = pd.DataFrame({"w": [["a"]] * 9000})
    for mod in (PT, JT):
        with pytest.raises(TypeError, match="run Tokenizer first"):
            mod.HashingTF().setInputCol("text").setNumFeatures(8).transform(docs)
        with pytest.raises(ValueError) as e:
            mod.HashingTF().setInputCol("w").setNumFeatures(1 << 18).transform(big)
        assert "lower setNumFeatures" in str(e.value) and "17.6 GiB" in str(e.value)
        with pytest.raises(ValueError, match="numFeatures must be >= 1"):
            mod.HashingTF().setNumFeatures(0)
    assert PT.HashingTF._MAX_DENSE_BYTES == JT.HashingTF._MAX_DENSE_BYTES


@pytest.mark.parametrize("min_doc_freq", [0, 3])
def test_idf_matches_jax(docs, min_doc_freq):
    _, mat, tf = _tf(JT, docs, 64)
    p = PT.IDF(minDocFreq=min_doc_freq).setInputCol("tf").setOutputCol("tfidf").fit(tf)
    j = JT.IDF().setMinDocFreq(min_doc_freq).setInputCol("tf").setOutputCol("tfidf").fit(tf)
    np.testing.assert_allclose(p.idf, j.idf, rtol=1e-12)
    np.testing.assert_array_equal(p.docFreq, j.docFreq)
    assert p.numDocs == j.numDocs == len(docs)
    df = (mat > 0).sum(0)
    want = np.where(df >= min_doc_freq, np.log((len(docs) + 1.0) / (df + 1.0)), 0.0)
    np.testing.assert_allclose(p.idf, want, rtol=1e-12)
    np.testing.assert_allclose(np.stack(p.transform(tf)["tfidf"]),
                               np.stack(j.transform(tf)["tfidf"]), rtol=1e-12)
    with pytest.raises(ValueError, match="fitted on 64"):
        p.transform(np.ones((2, 8)))


def test_idf_model_crosses_as_arrays_and_saves(docs, tmp_path):
    _, mat, tf = _tf(JT, docs, 32)
    j = JT.IDF(minDocFreq=1).setInputCol("tf").setOutputCol("tfidf").fit(tf)
    p = convert.model_from_arrays("IDFModel", j._saveData(), device="cpu",
                                  params=dict(j._paramMap))
    np.testing.assert_array_equal(p.transform(mat), j.transform(mat))
    j.save(str(tmp_path / "j"))
    loaded = Saveable.load(str(tmp_path / "j"), device="cpu")
    np.testing.assert_array_equal(loaded.idf, j.idf)
    assert loaded.numDocs == j.numDocs and loaded.getOutputCol() == "tfidf"
    p.save(str(tmp_path / "p"))
    again = JT.IDFModel._fromSaved("u", jax_persistence.load_arrays(str(tmp_path / "p")))
    np.testing.assert_array_equal(again.idf, j.idf)
    np.testing.assert_array_equal(again.docFreq, j.docFreq)
