"""The port's UMAP (``ops/umap.py``, ``models/umap.py``) against the JAX
package's.

Both packages get the same f32 rows (numpy seed); the port runs with
device="cpu". Tolerances and properties:

- the k-NN graph: squared distances within 64 unit roundoffs of the
  largest squared row norm (both packages expand ‖x‖² + ‖y‖² − 2x·y in f32,
  whose cancellation error scales with the norms, in their own orders);
  ids equal but at near ties, where the port's id lies within that bound of
  the JAX package's distance (measured in f64);
- on the JAX package's graph: ``smooth_knn_calibration`` rho exactly and
  sigma rtol 1e-6, ``membership_strengths`` rtol 1e-6; the host pieces
  (``fuzzy_union_edges``, ``find_ab_params``, ``spectral_init``) exactly;
- ``optimize_layout`` fed the JAX package's negatives (the port's own come
  from a torch generator): 5 epochs within 1e-4·max|y| (the CPU scatters
  add in edge order in both packages, so only the power and division
  roundings differ);
- whole fits (different negatives, a chaotic layout): held to
  ``tests/test_umap.py``'s structure measures, trustworthiness > 0.9 and
  inter-cluster distance > 3 × intra-cluster spread, on both packages;
- transform, persistence arrays and params are the JAX package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import umap as JMU
from spark_rapids_ml_tpu.models.neighbors import _finalize_distances as jax_finalize
from spark_rapids_ml_tpu.ops import neighbors as JNN
from spark_rapids_ml_tpu.ops import umap as JU
from spark_rapids_ml_tpu_torch import UMAP, UMAPModel
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models import umap as PMU
from spark_rapids_ml_tpu_torch.ops import umap as PU

CPU = torch.device("cpu")
K = 10


@pytest.fixture(scope="module")
def blobs():
    """``tests/test_umap.py``'s four blobs, as f32."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=12, size=(4, 12))
    x = np.concatenate([c + rng.normal(scale=0.6, size=(120, 12)) for c in centers])
    labels = np.repeat(np.arange(4), 120)
    perm = rng.permutation(len(x))
    return x[perm].astype(np.float32), labels[perm]


@pytest.fixture(scope="module")
def jax_graph(blobs):
    x, _ = blobs
    s, i = JNN.knn_topk(jnp.asarray(x), jnp.asarray(x), jnp.asarray(np.ones(len(x), bool)), K + 1)
    d = jax_finalize(np.asarray(s), "euclidean")[:, 1:]
    return d.astype(np.float32), np.asarray(i)[:, 1:]


def _structure(x, emb, labels):
    """(trustworthiness@10, inter-cluster distance / intra-cluster spread)."""
    from sklearn.manifold import trustworthiness

    tw = trustworthiness(x, emb, n_neighbors=10)
    intra = np.mean([np.linalg.norm(emb[labels == c] - emb[labels == c].mean(0), axis=1).mean()
                     for c in range(4)])
    cmeans = np.stack([emb[labels == c].mean(0) for c in range(4)])
    inter = np.mean([np.linalg.norm(cmeans[i] - cmeans[j])
                     for i in range(4) for j in range(i + 1, 4)])
    return tw, inter / intra


def test_knn_graph_equals_jax_up_to_near_ties(blobs, jax_graph):
    x, _ = blobs
    ref_d, ref_i = jax_graph
    d, i = PMU.knn_graph(torch.from_numpy(x), torch.from_numpy(x), K + 1)
    d, i = d[:, 1:], i[:, 1:]
    bound = 64 * 2.0**-24 * float(np.max(np.sum(x.astype(np.float64) ** 2, axis=1)))
    np.testing.assert_allclose(d.astype(np.float64) ** 2, ref_d.astype(np.float64) ** 2,
                               rtol=0, atol=bound)
    rows, cols = np.nonzero(i != ref_i)
    for r, c in zip(rows, cols):
        # the port's id sits at the JAX package's distance: a near tie
        got = np.sum((x[r].astype(np.float64) - x[i[r, c]]) ** 2)
        assert abs(got - float(ref_d[r, c]) ** 2) <= bound
    assert len(rows) <= 0.01 * i.size


def test_calibration_and_memberships_equal_jax(jax_graph):
    d, _ = jax_graph
    ref_rho, ref_sigma = (np.asarray(a) for a in JU.smooth_knn_calibration(jnp.asarray(d)))
    rho, sigma = PU.smooth_knn_calibration(torch.from_numpy(d))
    np.testing.assert_array_equal(rho.numpy(), ref_rho)
    np.testing.assert_allclose(sigma.numpy(), ref_sigma, rtol=1e-6)
    ref_w = np.asarray(JU.membership_strengths(jnp.asarray(d), jnp.asarray(ref_rho),
                                               jnp.asarray(ref_sigma)))
    w = PU.membership_strengths(torch.from_numpy(d), torch.from_numpy(ref_rho.copy()),
                                torch.from_numpy(ref_sigma.copy())).numpy()
    np.testing.assert_allclose(w, ref_w, rtol=1e-6)
    # each row's calibrated mass is log2(k)
    mass = np.exp(-np.maximum(d - rho.numpy()[:, None], 0.0) / sigma.numpy()[:, None]).sum(1)
    np.testing.assert_allclose(mass, np.log2(K), rtol=1e-4)


def test_host_pieces_are_the_jax_packages(jax_graph):
    d, i = jax_graph
    w = np.asarray(JU.membership_strengths(jnp.asarray(d), *JU.smooth_knn_calibration(
        jnp.asarray(d))))
    for a, b in zip(PU.fuzzy_union_edges(i, w), JU.fuzzy_union_edges(i, w)):
        np.testing.assert_array_equal(a, b)
    assert PU.find_ab_params(1.0, 0.1) == JU.find_ab_params(1.0, 0.1)
    heads, tails, weights = JU.fuzzy_union_edges(i, w)
    np.testing.assert_array_equal(PU.spectral_init(heads, tails, weights, len(d), 2, 3),
                                  JU.spectral_init(heads, tails, weights, len(d), 2, 3))


@pytest.mark.parametrize("move_tails", [True, False])
def test_five_layout_epochs_with_jax_negatives_equal_jax(jax_graph, move_tails):
    d, i = jax_graph
    n = len(d)
    w = np.asarray(JU.membership_strengths(jnp.asarray(d), *JU.smooth_knn_calibration(
        jnp.asarray(d))))
    heads, tails, weights = JU.fuzzy_union_edges(i, w)
    heads_d, tails_d = np.concatenate([heads, tails]), np.concatenate([tails, heads])
    weights_d = np.concatenate([weights, weights])
    eps = (weights_d.max() / weights_d).astype(np.float32)
    emb0 = JU.spectral_init(heads, tails, weights, n, 2, 0).astype(np.float32)
    a, b = JU.find_ab_params(1.0, 0.1)
    a32, b32 = np.float32(a), np.float32(b)
    key = jax.random.PRNGKey(4)
    ref = np.asarray(JU.optimize_layout(
        key, jnp.asarray(emb0), jnp.asarray(heads_d), jnp.asarray(tails_d), jnp.asarray(eps),
        jnp.asarray(a32), jnp.asarray(b32), n_epochs=5, move_tails=move_tails))

    def jax_negatives(epoch):
        draw = jax.random.randint(jax.random.fold_in(key, epoch), (len(heads_d), 5), 0, n)
        return torch.from_numpy(np.array(draw))

    got = PU.optimize_layout(
        torch.from_numpy(emb0), torch.from_numpy(heads_d.astype(np.int64)),
        torch.from_numpy(tails_d.astype(np.int64)), torch.from_numpy(eps), float(a32),
        float(b32), n_epochs=5, move_tails=move_tails, neg_fn=jax_negatives).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_whole_fit_preserves_structure_as_jax_does(blobs):
    x, labels = blobs
    ref = JMU.UMAP().setNNeighbors(12).setNEpochs(200).setSeed(3).fit(x)
    port = UMAP(device=CPU).setNNeighbors(12).setNEpochs(200).setSeed(3).fit(x)
    assert port.embedding_.shape == (len(x), 2) and port.fit_report is not None
    for emb in (ref.embedding_, port.embedding_):
        tw, separation = _structure(x, emb, labels)
        assert tw > 0.9 and separation > 3.0, (tw, separation)
    # same seed, same fit (the CPU scatters add in a fixed order)
    again = UMAP(device=CPU).setNNeighbors(12).setNEpochs(200).setSeed(3).fit(x)
    np.testing.assert_array_equal(again.embedding_, port.embedding_)


def test_transform_places_new_points_near_their_cluster(blobs):
    x, labels = blobs
    model = UMAP(device=CPU).setNNeighbors(12).setNEpochs(150).setSeed(5).fit(x[:400])
    out = model._embed_matrix(x[400:420])
    cmeans = np.stack([model.embedding_[labels[:400] == c].mean(0) for c in range(4)])
    assigned = np.linalg.norm(out[:, None, :] - cmeans[None], axis=2).argmin(1)
    assert (assigned == labels[400:420]).mean() >= 0.9
    assert model.transform_report is None
    model.transform(x[400:420])
    assert model.transform_report is not None


def test_params_and_messages_match_jax(blobs):
    x, _ = blobs
    port, ref = UMAP(device=CPU), JMU.UMAP()
    for name in ("nNeighbors", "nComponents", "nEpochs", "learningRate", "minDist", "spread",
                 "negativeSampleRate", "init", "seed", "outputCol"):
        assert port.getOrDefault(name) == ref.getOrDefault(name), name
    for setter, bad in (("setNNeighbors", 1), ("setNComponents", 0), ("setInit", "pca")):
        with pytest.raises(ValueError) as port_err:
            getattr(port, setter)(bad)
        with pytest.raises(ValueError) as ref_err:
            getattr(ref, setter)(bad)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="needs more than"):
        UMAP(device=CPU).setNNeighbors(15).fit(x[:10])


def test_jax_model_carries_across(blobs):
    x, _ = blobs
    ref = JMU.UMAP().setInit("random").setNEpochs(30).setSeed(2).fit(x[:150])
    port = model_from_arrays("UMAPModel", ref._saveData(), device="cpu",
                             params=dict(ref._paramMap))
    assert isinstance(port, UMAPModel) and (port.a, port.b) == (ref.a, ref.b)
    np.testing.assert_array_equal(port.embedding_, ref.embedding_)
    out = port._embed_matrix(x[150:170])
    assert out.shape == (20, 2) and np.isfinite(out).all()


@pytest.mark.cuda
def test_card_layout_epoch_follows_the_cpu(jax_graph):
    """One layout epoch on the card against the same epoch on the CPU in
    f64 with the same negatives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    d, i = jax_graph
    w = np.asarray(JU.membership_strengths(jnp.asarray(d), *JU.smooth_knn_calibration(
        jnp.asarray(d))))
    heads, tails, weights = JU.fuzzy_union_edges(i, w)
    heads_d, tails_d = np.concatenate([heads, tails]), np.concatenate([tails, heads])
    eps = np.concatenate([weights, weights])
    eps = eps.max() / eps
    emb0 = JU.spectral_init(heads, tails, weights, len(d), 2, 0)
    neg = torch.randint(0, len(d), (len(heads_d), 5), generator=torch.Generator().manual_seed(0))
    out = {}
    for dev, dt in (("cpu", torch.float64), ("cuda", torch.float32)):
        out[dev] = PU.optimize_layout(
            torch.from_numpy(emb0).to(dev, dt), torch.from_numpy(heads_d).long().to(dev),
            torch.from_numpy(tails_d).long().to(dev), torch.from_numpy(eps).to(dev, dt),
            1.577, 0.895, n_epochs=1, neg_fn=lambda e: neg).cpu().double().numpy()
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-4 * np.abs(out["cpu"]).max())
