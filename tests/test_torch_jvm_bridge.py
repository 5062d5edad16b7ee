"""The port's JVM bridge (``spark_rapids_ml_tpu_torch/jvm_bridge.py``) held
against the JAX package's (``spark_rapids_ml_tpu/jvm_bridge.py``).

Both packages' ``main(argv)`` run ``fit-pca`` and ``transform-pca`` over the
same two-part parquet directory (the port with ``--device cpu``), in
process. Tolerances: components within min |cosine| 0.9999 on a separated
spectrum (the port fits in f32, the JAX package under x64 in f64);
projections within 1e-5 of max |y| of JAX's; errors word for word. pyarrow
is imported inside the tests that write parquet, so a machine without it
can still collect the file and run its ``cuda`` test.
"""

import os
import subprocess
import sys

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import jvm_bridge as jbridge
from spark_rapids_ml_tpu.models.pca import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import jvm_bridge
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.ops import gram_moments as G

ROWS, N = 240, 8


def _separated(rows: int = ROWS, n: int = N, seed: int = 0) -> np.ndarray:
    """Rows whose covariance has well separated eigenvalues (scales 8, 7, … 1)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (rng.normal(size=(rows, n)) * np.arange(n, 0, -1.0)) @ q.T


def _write_parquet(path, x, col="features", ids=False):
    """A Spark-shaped two-part parquet directory of one list<double> column
    (and a row-id column)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    flat = pa.array(x.reshape(-1))
    offsets = pa.array(np.arange(0, x.size + 1, x.shape[1], dtype=np.int32))
    cols = {col: pa.ListArray.from_arrays(offsets, flat)}
    if ids:
        cols = {"id": pa.array(np.arange(len(x), dtype=np.int64)), **cols}
    table = pa.table(cols)
    path.mkdir(parents=True, exist_ok=True)
    half = len(x) // 2
    pq.write_table(table.slice(0, half), path / "part-00000.snappy.parquet")
    pq.write_table(table.slice(half), path / "part-00001.snappy.parquet")
    (path / "_SUCCESS").write_text("")


def _min_abs_cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))).min())


def _both(argv: list[str], tmp_path, tag: str) -> dict:
    """Run ``argv`` through both packages' ``main``, each with outputs under
    its own directory (``{out}`` in argv); returns each output path."""
    outs = {}
    for name, main, extra in (("port", jvm_bridge.main, ["--device", "cpu"]),
                              ("jax", jbridge.main, [])):
        out = tmp_path / f"{tag}-{name}"
        main([a.replace("{out}", str(out)) for a in argv] + extra)
        outs[name] = out
    return outs


@pytest.mark.parametrize("solver,centering,layout", [
    ("full", False, "spark"), ("svd", True, "spark"), ("full", False, "native"),
])
def test_fit_pca_matches_jax(tmp_path, solver, centering, layout):
    x = _separated() + (3.0 if centering else 0.0)
    _write_parquet(tmp_path / "in", x)
    argv = ["fit-pca", "--input", str(tmp_path / "in"), "--output", "{out}", "--k", "3",
            "--solver", solver, "--layout", layout, "--num-partitions", "2"]
    if centering:
        argv.append("--mean-centering")
    outs = _both(argv, tmp_path, "model")
    port = PCAModel.load(str(outs["port"]), device="cpu")
    ref = JaxPCAModel.load(str(outs["jax"]))
    assert port.pc.shape == ref.pc.shape == (N, 3)
    assert _min_abs_cosine(port.pc, ref.pc) >= 0.9999
    np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, rtol=1e-5)
    assert jax_persistence.is_spark_ml_layout(str(outs["port"])) == (layout == "spark")
    if layout == "spark":
        # the stock layout is what the Scala shim loads: JAX's own reader
        # takes the port's save (a native save names the port's class)
        across = JaxPCAModel.load(str(outs["port"]))
        np.testing.assert_array_equal(across.pc, port.pc.astype(across.pc.dtype))


def test_transform_pca_matches_jax(tmp_path):
    import pyarrow.parquet as pq

    x = _separated(seed=1)
    _write_parquet(tmp_path / "in", x)
    models = _both(["fit-pca", "--input", str(tmp_path / "in"), "--output", "{out}",
                    "--k", "3"], tmp_path, "model")
    _write_parquet(tmp_path / "staged", x, ids=True)
    got = {}
    for name, main, extra in (("port", jvm_bridge.main, ["--device", "cpu"]),
                              ("jax", jbridge.main, [])):
        out = tmp_path / f"result-{name}"
        main(["transform-pca", "--input", str(tmp_path / "staged"), "--model",
              str(models[name]), "--output", str(out), "--batch-rows", "100"] + extra)
        got[name] = pq.read_table(out)
    port, ref = got["port"], got["jax"]
    assert port.schema == ref.schema
    assert port.column_names == ["id", "features", "pca_features"]
    np.testing.assert_array_equal(port.column("id").to_numpy(), np.arange(ROWS))
    y = np.stack(port.column("pca_features").to_pylist())
    y_ref = np.stack(ref.column("pca_features").to_pylist())
    assert y.dtype == np.float64 and y.shape == (ROWS, 3)
    assert np.abs(y - y_ref).max() <= 1e-5 * np.abs(y_ref).max()


def test_halves_are_the_cli_without_parquet(tmp_path):
    """fit_pca_matrix and project_batches are the CLI's compute: the model and
    projections the CLI writes, with no parquet around them."""
    import pyarrow.parquet as pq

    x = _separated(seed=2)
    _write_parquet(tmp_path / "in", x)
    jvm_bridge.main(["fit-pca", "--input", str(tmp_path / "in"), "--output",
                     str(tmp_path / "m"), "--k", "3", "--device", "cpu"])
    saved = PCAModel.load(str(tmp_path / "m"), device="cpu")
    model = jvm_bridge.fit_pca_matrix(x, k=3, device="cpu")
    np.testing.assert_array_equal(model.pc, saved.pc)
    jvm_bridge.main(["transform-pca", "--input", str(tmp_path / "in"), "--model",
                     str(tmp_path / "m"), "--output", str(tmp_path / "r"),
                     "--batch-rows", "64", "--device", "cpu"])
    written = np.stack(pq.read_table(tmp_path / "r").column("pca_features").to_pylist())
    batches = [x[a:a + 64] for a in range(0, ROWS, 64)]
    np.testing.assert_array_equal(np.concatenate(list(jvm_bridge.project_batches(model, batches))),
                                  written)


@pytest.mark.parametrize("command", ["fit-pca", "transform-pca"])
def test_missing_column_is_the_same_error(tmp_path, command):
    x = _separated(seed=3)
    _write_parquet(tmp_path / "model-in", x)
    jbridge.main(["fit-pca", "--input", str(tmp_path / "model-in"), "--output",
                  str(tmp_path / "m"), "--k", "2"])
    _write_parquet(tmp_path / "in", x, col="other")
    argv = (["fit-pca", "--input", str(tmp_path / "in"), "--output", str(tmp_path / "o"),
             "--k", "2"] if command == "fit-pca" else
            ["transform-pca", "--input", str(tmp_path / "in"), "--model", str(tmp_path / "m"),
             "--output", str(tmp_path / "o")])
    messages = []
    for main, extra in ((jvm_bridge.main, ["--device", "cpu"]), (jbridge.main, [])):
        with pytest.raises(SystemExit, match="'features' not in") as err:
            main(argv + extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_existing_output_column_is_the_same_error(tmp_path):
    x = _separated(seed=4)
    _write_parquet(tmp_path / "in", x)
    jbridge.main(["fit-pca", "--input", str(tmp_path / "in"), "--output",
                  str(tmp_path / "m"), "--k", "2"])
    argv = ["transform-pca", "--input", str(tmp_path / "in"), "--model", str(tmp_path / "m"),
            "--output", str(tmp_path / "o"), "--output-col", "features"]
    messages = []
    for main, extra in ((jvm_bridge.main, ["--device", "cpu"]), (jbridge.main, [])):
        with pytest.raises(SystemExit, match="already exists") as err:
            main(argv + extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_usage_errors_never_touch_a_device(monkeypatch, capsys):
    def touched(device):
        raise AssertionError(f"the device {device!r} was probed")

    monkeypatch.setattr(jvm_bridge, "_claim_device", touched)
    with pytest.raises(SystemExit) as err:
        jvm_bridge.main(["fit-pca", "--input", "in", "--output", "out"])  # no --k
    assert err.value.code == 2 and "--k" in capsys.readouterr().err
    with pytest.raises(SystemExit) as err:
        jvm_bridge.main(["fit-pca", "--input", "in", "--output", "out", "--k", "2",
                         "--device", "tpu"])
    assert err.value.code == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the no-card message; a card answers")
def test_no_card_ends_with_a_message_not_a_fallback(tmp_path):
    """Without a card, --device cuda (the default) ends the process before any
    input is read, naming the fix; it never falls back to the CPU."""
    with pytest.raises(SystemExit) as err:
        jvm_bridge.main(["fit-pca", "--input", str(tmp_path / "absent"), "--output",
                         str(tmp_path / "m"), "--k", "2"])
    message = str(err.value)
    assert message.startswith("jvm_bridge: ") and "--device cpu" in message
    assert not (tmp_path / "m").exists()


def test_help_in_a_fresh_interpreter():
    """The Scala shim's literal entry point: --help prints the usage of both
    subcommands and exits 0 without a device probe (the timeout of 0 s would
    fail one)."""
    r = subprocess.run(
        [sys.executable, "-m", "spark_rapids_ml_tpu_torch.jvm_bridge", "fit-pca", "--help"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "TPU_ML_WORKER_PROBE_TIMEOUT": "0"},
    )
    assert r.returncode == 0, r.stderr
    assert "--num-partitions" in r.stdout and "--device" in r.stdout


@pytest.mark.cuda
def test_fit_half_on_card_against_cpu(monkeypatch):
    """fit-pca's fit half at TPU_ML_DEFAULT_PRECISION=high on the card: one
    fused_gram_moments launch a partition, components against the same fit
    on the CPU (the kernel's plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("TPU_ML_DEFAULT_PRECISION", "high")
    x = _separated(rows=20_000, n=64, seed=5).astype(np.float32)
    before = G.launches
    card = jvm_bridge.fit_pca_matrix(x, k=8, num_partitions=4, device="cuda")
    assert G.launches - before == 4
    cpu = jvm_bridge.fit_pca_matrix(x, k=8, num_partitions=4, device="cpu")
    assert card.getOrDefault("precision") == cpu.getOrDefault("precision") == "high"
    assert _min_abs_cosine(card.pc, cpu.pc) >= 0.9999
    np.testing.assert_allclose(card.explainedVariance, cpu.explainedVariance, rtol=1e-4)
