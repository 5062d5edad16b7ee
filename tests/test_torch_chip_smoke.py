"""chip_smoke.py's phases on the CPU at a tiny size.

On the CPU the kernel wrappers run their plain versions, so this checks the
script's shapes, control flow and checks, not the kernels; the script itself
refuses to run without a card.
"""

import os

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

import chip_smoke

CPU = torch.device("cpu")


def test_kernel_check_phase_on_cpu():
    results = chip_smoke.phase_kernel_check([(300, 40), (33, 7)], CPU)
    assert set(results) == {(300, 40), (33, 7)}
    for entry in results.values():
        assert entry["max_abs_err"] <= entry["tol"]
        assert entry["max_abs_err_vs_f64"] <= entry["tol"]
        assert entry["repeat_bit_equal"]


def test_symmetric_kernel_check_phase_on_cpu():
    # 300 columns: three 128-column tiles, so three mirrored tile pairs
    shapes = [(500, 300), (130, 200), (33, 7)]
    results = chip_smoke.phase_kernel_check(shapes, CPU, kernel="symmetric_gram_moments")
    assert set(results) == set(shapes)
    for entry in results.values():
        assert entry["max_abs_err"] <= entry["tol"]
        assert entry["max_abs_err_vs_f64"] <= entry["tol"]
        assert entry["mirror_bit_equal"] and entry["repeat_bit_equal"]


def test_mirror_check_catches_a_broken_mirror():
    g = chip_smoke.G.symmetric_gram_moments(torch.randn(50, 260))[0]
    assert chip_smoke._mirrored_tiles_equal(g)
    g[200, 3] = torch.nextafter(g[200, 3], torch.tensor(float("inf")))
    assert not chip_smoke._mirrored_tiles_equal(g)


def test_kernel_shapes_follow_the_main_paths():
    assert chip_smoke.KERNEL_SHAPES["gram_moments"][0] == chip_smoke.MAIN_SHAPE
    chunk, tail = chip_smoke.KERNEL_SHAPES["symmetric_gram_moments"][:2]
    rows = chip_smoke.STREAM_ROWS
    assert chunk == (65_536, 512) and tail == (38_528, 512)
    assert (rows // chunk[0]) * chunk[0] + tail[0] == rows  # 152 chunks and a tail
    assert set(chip_smoke.KERNELS) == set(chip_smoke.FUNCTIONS) == set(chip_smoke.KERNEL_SHAPES)


def test_main_path_phase_on_cpu():
    result = chip_smoke.phase_main_path(3000, 96, 5, 3, CPU)
    # plain versions on the CPU
    assert result["launches"] == {name: 0 for name in chip_smoke.KERNELS}
    assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert result["transform_max_abs_err"] <= result["transform_tol"]


def test_streamed_path_phase_on_cpu(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(1 << 20))
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "512")
    result = chip_smoke.phase_streamed_path(4096, 64, 5, 4, CPU)
    assert result["chunks"] == 8 and result["chunk_rows"] == 512
    assert result["launches"] == {name: 0 for name in chip_smoke.KERNELS}
    assert result["max_put_bytes"] == 512 * 64 * 4
    assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert result["min_cosine_high_vs_highest"] >= chip_smoke.COSINE_BAR


def test_streamed_path_phase_refuses_resident_data():
    with pytest.raises(AssertionError, match="cutover"):
        chip_smoke.phase_streamed_path(1024, 16, 3, 2, CPU)


def test_streamed_workload_is_seeded_and_its_gram_exact():
    x, g = chip_smoke.streamed_workload(1000, 24, 3, CPU)
    x2, _ = chip_smoke.streamed_workload(1000, 24, 3, CPU)
    assert x.dtype == np.float32 and x.shape == (1000, 24)
    np.testing.assert_array_equal(x, x2)
    xd = x.astype(np.float64)
    np.testing.assert_allclose(g, xd.T @ xd, rtol=1e-12)


def test_standardize_phase_on_cpu():
    result = chip_smoke.phase_standardize(3000, 96, 5, 3, CPU)
    assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert result["std_max_rel_err"] < 1e-4


def test_bound_at_main_shape():
    bound_ms, bound_by = chip_smoke.gram_bound(65_536, 512)
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(65_536 * 512 * (3 * 512 + 1) / 989e12 * 1e3)


def test_workload_is_seeded_f32():
    a, b = chip_smoke.bench_workload(50, 70), chip_smoke.bench_workload(50, 70)
    assert a.dtype == np.float32 and a.shape == (50, 70)
    np.testing.assert_array_equal(a, b)


def test_main_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


PTXAS_LOG = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gram_partial_kernelILb1ELi3EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_119gram_partial_kernelILb1ELi3EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gram_partial_kernelILb0ELi3EEEvPKf' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 3 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119gram_partial_kernelILb0ELi1EEEvPKf' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 160 registers, used 3 barriers
"""
SASS = """	code for sm_90a
		Function : _ZN12_GLOBAL__N_119gram_partial_kernelILb0ELi3EEEvPKf
        /*0100*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0110*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
		Function : _ZN12_GLOBAL__N_118gram_reduce_kernelILb1EEEvPKf
        /*0100*/   FADD R1, R2, R3 ;
		Function : _ZN12_GLOBAL__N_119gram_partial_kernelILb1ELi3EEEvPKf
        /*0100*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
		Function : _ZN12_GLOBAL__N_119gram_partial_kernelILb1ELi1EEEvPKf
        /*0100*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0110*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24 ;
        /*0120*/   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], R24 ;
"""


def test_build_report_reads_each_instance():
    """Each kernel's instance by its template arguments <symmetric,
    products> in the mangled name: a one-product instance is not read as
    its three-product twin, nor the reverse."""
    report = chip_smoke.build_report(PTXAS_LOG, SASS)
    fused, symmetric = report["gram_moments"], report["symmetric_gram_moments"]
    assert fused["hgmma"] == 2 and symmetric["hgmma"] == 1
    assert fused["spill_bytes"] == 12 and symmetric["spill_bytes"] == 0
    assert any("168 registers" in line for line in symmetric["ptxas"])
    one, sym_one = report["gram_moments_1pass"], report["symmetric_gram_moments_1pass"]
    assert one["hgmma"] == 0 and any("160 registers" in line for line in one["ptxas"])
    assert sym_one["hgmma"] == 3 and sym_one["ptxas"] == []
    assert chip_smoke.build_report("", "") == {
        k: {"ptxas": [], "spill_bytes": 0, "hgmma": 0} for k in chip_smoke.INSTANCES
    }


def test_schedule_summary_at_the_main_shapes():
    fused = chip_smoke.schedule_summary(65_536, 512, False, 132)
    assert fused["blocks"] == 132 and fused["tiles"] == 16
    assert fused["steps_per_sm"] == [248, 249]
    symmetric = chip_smoke.schedule_summary(65_536, 512, True, 132)
    assert symmetric["tiles"] == 10 and symmetric["steps_per_sm"] == [155, 156]
    assert symmetric["items_per_sm"][0] >= 1


def test_kernel_checks_take_both_load_routes():
    for name, shapes in chip_smoke.KERNEL_SHAPES.items():
        routes = {"tma" if n % 4 == 0 else "plain" for _, n in shapes}
        assert routes == {"tma", "plain"}, name
        assert (65_536, 129) in shapes


@pytest.mark.parametrize("kernel", ["gram_moments_1pass", "symmetric_gram_moments_1pass"])
def test_one_pass_kernel_check_phase_on_cpu(kernel):
    shapes = [(500, 300), (130, 200), (33, 7)]
    results = chip_smoke.phase_kernel_check(shapes, CPU, kernel=kernel)
    for entry in results.values():
        assert entry["max_abs_err"] <= entry["tol"]
        assert entry["max_abs_err_vs_f64"] <= entry["tol"]
        assert entry["repeat_bit_equal"] and entry.get("mirror_bit_equal", True)
    assert ("mirror_bit_equal" in results[(33, 7)]) == (kernel in chip_smoke.SYMMETRIC)


def test_four_kernels_each_with_its_instance_and_counter():
    assert set(chip_smoke.KERNELS) == set(chip_smoke.INSTANCES) == set(chip_smoke.COUNTERS)
    assert len(set(chip_smoke.INSTANCES.values())) == 4
    assert chip_smoke.INSTANCES["symmetric_gram_moments_1pass"] == "gram_partial_kernelILb1ELi1E"
    for name, counter in chip_smoke.COUNTERS.items():
        assert hasattr(chip_smoke.G, counter), name
    shapes = chip_smoke.KERNEL_SHAPES
    assert shapes["gram_moments_1pass"] == shapes["gram_moments"]
    chip_smoke.reset_launches()
    assert chip_smoke.read_launches() == chip_smoke.expected_launches()
    assert chip_smoke.expected_launches(gram_moments_1pass=8)["gram_moments_1pass"] == 8


def test_one_pass_bound_at_main_shape():
    """One product over the upper triangle, rows·n·(n+1) operations, against
    X read once: 65,536 × 512 is bound by its bytes."""
    bound_ms, bound_by = chip_smoke.gram_bound(65_536, 512, products=1)
    assert bound_by == "bytes"
    nbytes = 4.0 * (65_536 * 512 + 512 * 512 + 2 * 512)
    assert bound_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert 65_536 * 512 * 513 / 989e12 * 1e3 == pytest.approx(0.0174, rel=1e-2)
    assert bound_ms == pytest.approx(0.0401, rel=1e-2)


def test_solvers_phase_on_cpu():
    result = chip_smoke.phase_solvers(3000, 256, 6, 3, CPU)
    assert result["auto_bit_equal_randomized"] and result["same_sketch"]
    assert result["svd_min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert result["randomized_min_cosine_vs_f64_hmt"] >= chip_smoke.COSINE_BAR
    assert set(result["decomposition_ms"]) == {"full", "randomized", "svd"}


def test_randomized_f64_is_the_ports_solver_in_f64():
    """The smoke's host reference of the randomized steps against the port's
    solver run in f64 on the same sketch."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 40)) @ rng.normal(size=(40, 40))
    scatter = x.T @ x
    omega = rng.normal(size=(40, 15))
    pc, ev = chip_smoke.randomized_f64(scatter, 5, omega)
    tpc, tev = chip_smoke.L.pca_fit_from_cov(torch.from_numpy(scatter), 5, solver="randomized")
    u, s, tail = chip_smoke.L.randomized_eigh_descending(
        torch.from_numpy(scatter), 5, omega=torch.from_numpy(omega))
    np.testing.assert_allclose(pc, u.numpy(), rtol=0, atol=1e-10)
    ref_ev = chip_smoke.L.explained_variance_from_partial(
        s, torch.trace(torch.from_numpy(scatter)), tail)[:5]
    np.testing.assert_allclose(ev, ref_ev.numpy(), rtol=1e-10)
    np.testing.assert_allclose(chip_smoke.scatter_f64(x.astype(np.float32), CPU, chunk=64),
                               x.astype(np.float32).astype(np.float64).T
                               @ x.astype(np.float32).astype(np.float64), rtol=1e-12)


def test_one_pass_phase_on_cpu():
    result = chip_smoke.phase_one_pass(3000, 96, 5, 3, CPU)
    assert result["launches"] == chip_smoke.expected_launches()
    assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR


def test_streamed_one_pass_phase_on_cpu(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(1 << 20))
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "512")
    monkeypatch.delenv("TPU_ML_PRECISION_POLICY", raising=False)
    data = chip_smoke.streamed_workload(4096, 64, 4, CPU)
    result = chip_smoke.phase_streamed_one_pass(data, 5, 4, CPU, policy_rows=3000)
    assert result["chunks"] == 8 and result["policy_chunks"] == 6
    assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert result["policy_min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert "TPU_ML_PRECISION_POLICY" not in os.environ


def _fixed_coalescing_window(monkeypatch):
    """A fixed 20 ms window for the CPU's mixed traffic: the adaptive
    window follows the dispatch time, a few hundred µs on the CPU, and on a
    loaded host the threads' requests then rarely meet in one window, so
    the coalescing gate (fewer dispatches than requests) read the load
    rather than the batcher."""
    monkeypatch.setenv("TPU_ML_SERVE_ADAPTIVE_WINDOW", "0")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_DELAY_US", "20000")


def test_serving_phase_on_cpu(monkeypatch):
    """Phase 10 at a tiny size: no graphs on the CPU, so no captures are
    expected; every other gate (bit for bit against the eager transform at
    each rung and on the one-row wires, the f64 bound, the fast lane's zero
    JSON, coalescing under threads, paging) holds here as on the card."""
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    _fixed_coalescing_window(monkeypatch)
    x = chip_smoke.bench_workload(2000, 32)
    model = chip_smoke.PCA(device=CPU).setK(4).fit(x)
    std_model = chip_smoke.PCA(device=CPU).setK(4).setStandardize(True).fit(x)
    result = chip_smoke.phase_serving(
        model, std_model, CPU, latency_requests=12, mixed_requests=48, threads=4,
        paging_requests=8, pool_rows=512, reps=2,
    )
    reg = result["registration"]
    assert reg["ladder"] == [8, 16, 32, 64] and reg["aot_compiles"] == 0
    assert set(result["rungs"]) == {"pca512", "pca512_std", "pca512_bf16"}
    assert result["rungs"]["pca512_bf16"]["policy"] == "bf16_f32acc"
    for wire in chip_smoke.WIRES:
        assert result["latency"][wire]["n"] == 12
        assert result["latency"][wire]["bitwise_mismatches"] == 0
    assert result["latency"]["fast"]["json_codec"] == 0
    assert result["mixed"]["requests"] == 48
    assert result["mixed"]["batches"] < 48
    assert set(result["batcher_alone"]) == {"direct", "batcher", "batcher_zero_window"}
    assert all(v["n"] == 12 for v in result["batcher_alone"].values())
    assert result["paging"]["page_out"] > 0 and result["paging"]["page_in"] > 0
    assert chip_smoke.hbm.get_fleet().stats()["models"] == {}


def test_serving_gates_catch_a_wrong_answer(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "16")
    x = chip_smoke.bench_workload(500, 16)
    model = chip_smoke.PCA(device=CPU).setK(3).fit(x)
    reg = chip_smoke.R.ModelRegistry(CPU)
    entry = reg.register("p", model)
    entry.params = (entry.params[0] * (1 + 1e-6),)  # off by one part in a million
    try:
        with pytest.raises(AssertionError, match="differs from eager|f64 error"):
            chip_smoke.serve_rung_checks(reg, CPU, x, reps=1)
    finally:
        chip_smoke.R.reset_for_tests()


def test_span_breakdown_joins_a_request_to_its_queue_and_dispatch():
    def span(name, ts, dur, **args):
        return {"name": name, "ph": "X", "ts": ts, "dur": dur, "args": args}

    events = [
        span("serve.queue", 110, 40, trace_id="t", span_id="q1", parent_id="r1"),
        span("serve.dispatch", 160, 30, links="t:r1 u:r2"),
        span("serve.request", 100, 120, trace_id="t", span_id="r1"),
        span("serve.queue", 5, 1, trace_id="v", span_id="q9", parent_id="gone"),
    ]
    out = chip_smoke.span_breakdown(events)
    assert {k: v["p50_us"] for k, v in out.items()} == {
        "prepare": 10, "queue": 40, "assemble": 10, "dispatch": 30, "after": 30,
    }
    assert all(v["n"] == 1 for v in out.values())


def test_config4_pipeline_phase_on_cpu():
    """Phase 11 at a tiny size: both pipelines held to their f64 oracles
    and to phase 7's model, their reports gated."""
    standardized = chip_smoke.phase_standardize(3000, 96, 5, 3, CPU)
    results = chip_smoke.phase_pipeline(3000, 96, 5, 3, CPU, standardized)
    assert set(results) == {"scaler", "normalizer"}
    for name, result in results.items():
        assert result["launches"] == chip_smoke.expected_launches()  # plain versions
        assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
        assert result["transform_max_abs_err"] <= result["transform_tol"]
        assert result["model"].fit_report.rows_ingested == 3000
    assert results["scaler"]["min_cosine_vs_standardize_fit"] >= chip_smoke.COSINE_BAR
    assert set(results["scaler"]["stage_fit_s"]) == {"StandardScalerModel", "PCAModel"}
    assert set(results["normalizer"]["stage_fit_s"]) == {"PCAModel"}


def test_streamed_scaler_phase_on_cpu(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(1 << 20))
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "512")
    data = chip_smoke.streamed_workload(4096, 64, 4, CPU)
    result = chip_smoke.phase_streamed_scaler(data, 4, CPU)
    assert result["chunks"] == 8 and result["rows_ingested"] == 4096
    assert result["h2d_bytes"] == 0 and result["overlap_fraction"] == 0.0
    assert result["std_max_rel_err"] <= chip_smoke.STREAM_SCALER_STD_RTOL


def test_streamed_scaler_phase_refuses_resident_data():
    data = chip_smoke.streamed_workload(1000, 24, 3, CPU)
    with pytest.raises(AssertionError, match="went resident"):
        chip_smoke.phase_streamed_scaler(data, 3, CPU)


def test_serving_phase_with_the_config4_scaler_on_cpu(monkeypatch):
    """Phase 10's additions at a tiny size: the scaler servable's rungs,
    the exporter holding a fit in /report, and shedding."""
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "32")
    _fixed_coalescing_window(monkeypatch)
    x = chip_smoke.bench_workload(2000, 32)
    model = chip_smoke.PCA(device=CPU).setK(4).fit(x)
    std_model = chip_smoke.PCA(device=CPU).setK(4).setStandardize(True).fit(x)
    pipeline = chip_smoke.Pipeline(stages=[
        chip_smoke.StandardScaler(device=CPU, withMean=True), chip_smoke.PCA(device=CPU).setK(4),
    ]).fit(x)
    result = chip_smoke.phase_serving(
        model, std_model, CPU, scaler_model=pipeline.stages[0],
        report_fit_ids=(pipeline.fit_report.fit_id,), latency_requests=6, mixed_requests=48,
        threads=4, paging_requests=4, shed_requests=60, pool_rows=256, reps=1,
    )
    assert result["rungs"]["scaler512"]["policy"] == "f32"
    assert all(r["bitwise_vs_eager_kernel"] and r["bitwise_vs_transform"]
               for r in result["rungs"]["scaler512"]["rungs"])
    assert result["exporter"]["/report"]["fit_ids"] == [pipeline.fit_report.fit_id]
    assert result["shedding"]["refuse"]["codes"].get("503", 0) >= 1
    assert result["shedding"]["off"]["codes"] == {"200": 60}


def test_exporter_checks_catch_a_missing_fit():
    with pytest.raises(AssertionError, match="lacks phase 11's fits"):
        chip_smoke.serve_exporter_checks(("no-such-fit",))


def test_config5_phase_on_cpu():
    """Phase 12 at a tiny size: both fits, the Lloyd step against f64, the
    block sizes, the two coarser policies, trainingCost and the transform,
    every gate held."""
    result = chip_smoke.phase_config5(6000, 16, 12, 3, CPU)
    assert result["iterations"] >= 1 and result["kmeans_par"]["iterations"] >= 1
    step = result["lloyd_step_vs_f64"]
    assert step["mismatches_not_near_tie"] == 0 and step["counts_equal_own_labels"]
    assert step["sums_normwise_err"] <= chip_smoke.KMEANS_RTOL
    assert result["training_cost_rel_err_vs_f64"] <= chip_smoke.KMEANS_RTOL
    assert result["transform_vs_f64"]["mismatches_not_near_tie"] == 0
    assert set(result["policies"]) == {"int8_dist", "bf16_f32acc"}
    assert result["lloyd_bound_by"] == "bytes"  # k=12: X's bytes outweigh the products
    assert result["h2d_bytes"] == 0 and result["lloyd_profile_ms_one_partition"] == {}


def test_config5_device_parts_are_the_fit_partitions():
    """The oracles' partitions, made again on the device, are the host
    matrix's rows split as the fit splits them, padded with zero weight."""
    x = chip_smoke.kmeans_workload(1001, 8, 5, 3, CPU, seed=4)
    parts = chip_smoke.kmeans_device_parts(1001, 8, 5, 3, CPU, seed=4)
    for (xp, w, m), split in zip(parts, np.array_split(x, 3)):
        assert m == len(split) and xp.shape[0] == chip_smoke.columnar.bucket_rows(m)
        np.testing.assert_array_equal(xp[:m].numpy(), split)
        assert float(w[:m].sum()) == m and float(w[m:].abs().sum()) == 0.0
    assert list(chip_smoke.partition_edges(1001, 3)) == [0, 334, 668, 1001]


def test_f64_pass_flags_a_label_off_beyond_a_near_tie():
    x = chip_smoke.kmeans_workload(3000, 8, 6, 2, CPU, seed=5)
    parts = chip_smoke.kmeans_device_parts(3000, 8, 6, 2, CPU, seed=5)
    centres = chip_smoke.kmeans_centres(6, 8, CPU, 5)
    good = chip_smoke.kmeans_f64_pass(parts, centres, 8192)
    assert good["mismatches_not_near_tie"] == 0
    given = [lab.clone() for lab in good["labels_f32"]]
    given[1][7] = (given[1][7] + 1) % 6
    bad = chip_smoke.kmeans_f64_pass(parts, centres, 8192, given=given)
    assert bad["mismatches_not_near_tie"] == 1
    assert abs(bad["cost64"] - good["cost64"]) <= 1e-9 * good["cost64"]
    assert x.shape == (3000, 8)


def test_distance_family_phase_on_cpu():
    """Phase 13 at a tiny size: DBSCAN against the f64 oracle, kNN against
    the f64 brute force, int8_dist's recall."""
    result = chip_smoke.phase_distance_family(CPU, grids=4, side=6, n=16, knn_rows=3000,
                                              knn_queries=200)
    db, kn = result["dbscan"], result["knn"]
    assert db["label_mismatches"] == 0 and db["min_rel_gap_to_eps"] > db["f32_reach_rel"]
    assert db["spans_s"].keys() == {"dbscan cluster"}
    assert kn["ids_outside_f64_top_k"] == 0 and kn["max_rel_dist_err"] <= chip_smoke.KNN_RTOL
    assert "knn kneighbors" in kn["spans_s"]


def test_dbscan_oracle_equals_the_jax_package():
    """The phase's f64 oracle gives the JAX package's DBSCAN labels on the
    phase's grids."""
    from spark_rapids_ml_tpu.models.dbscan import DBSCAN as JaxDBSCAN

    x = chip_smoke.dbscan_workload(3, 6, 16, CPU)
    oracle, _ = chip_smoke.dbscan_oracle_f64(x, chip_smoke.DBSCAN_EPS**2,
                                             chip_smoke.DBSCAN_MIN_SAMPLES, CPU, block=40)
    ref = JaxDBSCAN(eps=chip_smoke.DBSCAN_EPS, minSamples=chip_smoke.DBSCAN_MIN_SAMPLES) \
        .fit().clusterLabels(x)
    np.testing.assert_array_equal(oracle, ref)
    assert (oracle >= 0).any() and (oracle < 0).any()


def test_knn_f64_is_the_exact_top_k():
    gen = torch.Generator().manual_seed(2)
    corpus, queries = torch.randn(300, 6, generator=gen), torch.randn(20, 6, generator=gen)
    d, i = chip_smoke.knn_f64(queries, corpus, 4, chunk=7, block=50)
    full = ((queries.double()[:, None] - corpus.double()[None]) ** 2).sum(-1)
    ref_d, ref_i = torch.topk(full, 5, dim=1, largest=False)
    assert torch.equal(i, ref_i)
    torch.testing.assert_close(d, ref_d, rtol=1e-12, atol=1e-12)


# -- phase 14: the linear family ------------------------------------------------


@pytest.fixture
def linear_stream(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(1 << 16))
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "512")
    return chip_smoke.streamed_workload(3000, 48, 4, CPU)


def test_streamed_linreg_phase_on_cpu(linear_stream):
    result = chip_smoke.phase_streamed_linreg(linear_stream, 4, CPU)
    for label in ("plain", "weighted"):
        entry = result[label]
        assert entry["chunks"] == 6 and entry["h2d_bytes"] == 0
        assert entry["coef_err"] <= 1.01 * entry["coef_bound"] + 1e-9
        assert entry["xtx_rel_err"] <= chip_smoke.LINEAR_STATS_RTOL
    enet = result["elastic_net"]
    assert 0 < enet["nonzero"] <= 48
    assert enet["kkt_own_stats"] <= 1e-3 * chip_smoke.ENET_REG * chip_smoke.ENET_ALPHA
    assert 0.0 <= result["f32_carry_coef_rel_err"] and result["fold_bound_by"] == "operations"
    assert result["model"].stream_report is not None


def test_streamed_linreg_gates_catch_a_wrong_coefficient(linear_stream):
    x, _ = linear_stream
    work = chip_smoke.linreg_workload(x, CPU)
    oracle, _ = chip_smoke.linear_stats_f64(x, work["y"], None, CPU)
    coef, b0 = chip_smoke.normal_solve_f64(oracle)
    good = chip_smoke.linreg_gates(oracle, oracle, coef.numpy(), float(b0))
    assert good["coef_err"] <= 1e-9 * np.linalg.norm(coef.numpy())
    bad = coef.numpy().copy()
    bad[3] += 1e-3
    with pytest.raises(AssertionError, match="perturbation bound"):
        chip_smoke.linreg_gates(oracle, oracle, bad, float(b0))


def test_linear_serving_phase_on_cpu(linear_stream, monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    x, _ = linear_stream
    y = chip_smoke.linreg_workload(x, CPU)["y"]
    model = chip_smoke.LinearRegression(device=CPU).fit((x, y))
    out = chip_smoke.phase_linear_serving(model, x[:64], CPU, reps=2)
    assert out["rungs"] == 4 and out["captures"] == 0
    assert out["fast_lane_rel_err_vs_f64"] <= chip_smoke.SERVE_REL_TOL


def test_newton_fits_phase_on_cpu():
    x, _ = chip_smoke.streamed_workload(4000, 24, 2, CPU)
    result = chip_smoke.phase_newton_fits(x, CPU, rows=3000, softmax_rows=1500, classes=3,
                                          partitions=3)
    for label in ("logistic", "svc", "softmax"):
        assert result[label]["grad_rel"] <= chip_smoke.NEWTON_GRAD_RTOL
        assert result[label]["iterations"] >= 1
    assert result["resume"]["equal_to_uninterrupted"]
    assert result["softmax"]["block_products"] == 6
    assert result["logistic"]["obj_excess_rel"] <= chip_smoke.NEWTON_OBJ_RTOL


def test_newton_oracle_matches_the_jax_package():
    """The script's f64 Newton converges where the JAX package's binary and
    softmax fits (x64 on here) do: objectives rtol 1e-9."""
    from spark_rapids_ml_tpu.models.linear import LogisticRegression as JaxLogReg

    x, _ = chip_smoke.streamed_workload(2000, 12, 2, CPU)
    xd = torch.from_numpy(x)
    for classes in (None, 3):
        y = (chip_smoke._logistic_labels(xd, 3) if classes is None
             else chip_smoke._softmax_labels(xd, classes, 3))
        w, obj, _ = chip_smoke.newton_oracle_f64(xd, torch.from_numpy(y), 0.01, classes)
        ref = JaxLogReg().setRegParam(0.01).setTol(1e-12).setMaxIter(50).fit(
            (x.astype(np.float64), y))
        w_ref = torch.from_numpy(chip_smoke._newton_params(ref, classes))
        obj_ref = chip_smoke.newton_f64(xd, torch.from_numpy(y), w_ref, 0.01, classes,
                                        hessian=False)[0]
        assert obj == pytest.approx(obj_ref, rel=1e-9)


def test_spectral_incremental_phase_on_cpu():
    result = chip_smoke.phase_spectral_incremental(
        3000, 96, 5, 3, CPU, kmeans=dict(k=6, n=8, rows=2000, batches=3))
    for precision in ("highest", "high"):
        entry = result[precision]
        assert entry["tsvd_launches"] == {name: 0 for name in chip_smoke.KERNELS}
        assert entry["tsvd_min_cos_vs_f64"] >= chip_smoke.COSINE_BAR
        assert entry["incremental_pca_min_cos_vs_one_shot"] >= chip_smoke.COSINE_BAR
    linreg = result["incremental_linreg"]
    assert linreg["rows_seen"] == 3000
    assert linreg["coef_diff"] <= 1.01 * linreg["coef_diff_bound"]
    assert result["incremental_kmeans"]["max_rel_err_vs_f64_update"] <= chip_smoke.MINIBATCH_RTOL


# -- phase 15: approximate nearest neighbours -----------------------------------


@pytest.fixture
def ann_env(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.setenv("TPU_ML_ANN_SAMPLE_ROWS", "2000")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "4096")
    yield
    chip_smoke.R.reset_for_tests()


def test_ann_resident_and_serving_phases_on_cpu(ann_env):
    """Phase 15 (a) and (c) at a tiny size: the full probe inside the f64
    top k, the build's spans, every rung and wire answer the eager one, and
    ann.queries counting each request."""
    result = chip_smoke.phase_ann_resident(CPU, rows=6000, queries=300, n=16,
                                           full_probe_queries=150)
    assert result["nlist"] == 77 and result["full_probe"]["queries"] == 150
    assert result["full_probe"]["ids_outside_f64_top_k"] == 0
    assert result["build_spans_s"]["quantizer"] > 0 and result["build_spans_s"]["pack"] > 0
    assert 0 < result["recall_at_10"] <= 1
    served = chip_smoke.phase_ann_serving(result["model"], result["queries_h"], CPU, requests=6)
    assert served["rungs"] == 4 and served["captures"] == 0
    assert served["ann_queries_counted"] == served["requests"] == 21
    assert all(a["id_mismatches"] == 0 for a in served["answers"].values())


def test_ann_streamed_phase_on_cpu(ann_env):
    result = chip_smoke.phase_ann_streamed(CPU, rows=30000, chunk=7000, n=16, clusters=40,
                                           queries=150, latency_queries=3)
    assert result["chunks"] == 5 and result["build_rows"] == 30000
    assert result["pack_bucket_ids_equal"] and result["pack_spill_same_rows"]
    assert len(result["passes"]["lloyd_s"]) == chip_smoke.ANN_MAX_ITER
    recalls = [result["nprobe"][str(p)]["recall"] for p in chip_smoke.ANN_NPROBES]
    assert recalls == sorted(recalls) and recalls[-1] >= 0.9


def test_knn_f64_gate_catches_a_wrong_neighbour():
    corpus, queries = chip_smoke.knn_workload(500, 20, 8, CPU, 3)
    d64, i64 = chip_smoke.knn_f64(queries, corpus, 4)
    ids = i64[:, :4].numpy().copy()
    dist = np.sqrt(d64[:, :4].numpy())
    assert chip_smoke.knn_f64_gate(queries, corpus, ids, dist, d64, 4) == {
        "ids_outside_f64_top_k": 0, "max_rel_dist_err": pytest.approx(0.0, abs=1e-12)}
    far = int(torch.argmax(((corpus - queries[0]) ** 2).sum(1)))
    ids[0, 1] = far
    assert chip_smoke.knn_f64_gate(queries, corpus, ids, dist, d64, 4)[
        "ids_outside_f64_top_k"] == 1
    ids = i64[:, :4].numpy()
    assert chip_smoke.knn_f64_gate(queries, corpus, ids, dist * (1 + 1e-4), d64, 4)[
        "max_rel_dist_err"] > chip_smoke.KNN_RTOL


def test_streamed_pack_gate_catches_a_misplaced_row(ann_env, monkeypatch):
    from spark_rapids_ml_tpu_torch.ann.index import IVFFlatIndex

    pack = IVFFlatIndex._assign_and_pack

    def swapped(self, *args):
        packed = pack(self, *args)
        ids = packed.bucket_ids.copy()
        ids[0, 0], ids[1, 0] = ids[1, 0], ids[0, 0]
        return packed._replace(bucket_ids=ids)

    monkeypatch.setattr(IVFFlatIndex, "_assign_and_pack", swapped)
    with pytest.raises(AssertionError, match="streamed pack differs"):
        chip_smoke.phase_ann_streamed(CPU, rows=8000, chunk=3000, n=8, clusters=10,
                                      queries=40, nprobes=(1, 2), latency_queries=1)


def test_recall_gate_catches_a_falling_recall(ann_env, monkeypatch):
    from spark_rapids_ml_tpu_torch.ann.index import IVFFlatIndexModel

    search = IVFFlatIndexModel.search

    def worse_with_more_probes(self, queries, *, k=None, nprobe=None):
        d, i = search(self, queries, k=k, nprobe=nprobe)
        return (d, i + 1) if nprobe and nprobe > 1 else (d, i)

    monkeypatch.setattr(IVFFlatIndexModel, "search", worse_with_more_probes)
    with pytest.raises(AssertionError, match="recall falls"):
        chip_smoke.phase_ann_streamed(CPU, rows=8000, chunk=3000, n=8, clusters=10,
                                      queries=40, nprobes=(1, 2), latency_queries=1)


def test_ann_rung_gate_catches_a_wrong_replay(ann_env, monkeypatch):
    rows = np.random.default_rng(4).normal(size=(3000, 8)).astype(np.float32)
    model = chip_smoke.ApproximateNearestNeighbors(device=CPU, k=5, nlist=10).fit(rows)
    dispatch = chip_smoke.R.ModelRegistry.dispatch_padded

    def off_by_one_ulp(self, entry, padded, bucket):
        out = dispatch(self, entry, padded, bucket)
        out[0, 0] = np.nextafter(out[0, 0], np.float32(np.inf))
        return out

    monkeypatch.setattr(chip_smoke.R.ModelRegistry, "dispatch_padded", off_by_one_ulp)
    with pytest.raises(AssertionError, match="replay differs"):
        chip_smoke.phase_ann_serving(model, rows, CPU, requests=2)


# -- phase 16: trees and NaiveBayes ---------------------------------------------


def test_trees_nb_phase_on_cpu(monkeypatch):
    """Phase 16 at a tiny size: both forests inside the f64 split gate, the
    tree bit for bit its CPU build, the servable's rungs, NaiveBayes
    statistics within 1e-5 of f64."""
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    result = chip_smoke.phase_trees_nb(CPU, rows=20000, test_rows=4000, trees=3, depth=4,
                                       bins=16, tree_rows=3000, nb_rows=6000, nb_n=32,
                                       nb_classes=4, nb_predict_rows=1000)
    for name in ("classifier", "regressor"):
        gate = result[name]["split_gate"]
        assert gate["violations"] == 0 and gate["nodes_checked"] > 3
        assert len(gate["hist_ms_per_level"]) == 4
    assert result["classifier"]["held_out_accuracy"] > 0.6
    assert result["decision_tree"]["bit_equal_to_cpu"]
    assert all(result["forest_serving"]["rungs_bit_equal"].values())
    for name in ("nb_gaussian", "nb_multinomial"):
        assert result[name]["max_stat_rel_err"] <= chip_smoke.NB_RTOL
        assert result[name]["prediction_mismatches_beyond_near_ties"] == 0
    chip_smoke.R.reset_for_tests()


def test_split_gate_catches_a_worse_split():
    x, y, _ = chip_smoke.higgs_workload(8000, 6, CPU, seed=5)
    est = chip_smoke.RandomForestClassifier(device=CPU, numTrees=2, maxDepth=3, maxBins=16,
                                            featureSubsetStrategy="all", seed=1)
    model = est.fit((x, y))
    edges = chip_smoke.PF.quantile_bin_edges(x, 16, 1)
    binned_t = chip_smoke.PF.bin_on_device(torch.from_numpy(x), edges)
    stats = torch.from_numpy(est._row_stats(y))
    weights = chip_smoke._bootstrap_weights(1, 2, len(x))

    def gate(trees):
        return chip_smoke.forest_split_gate(
            trees, binned_t, stats, weights, impurity="gini", k_features=6, seed=1,
            max_depth=3, n_bins=16)

    assert gate(model.trees)["violations"] == 0
    split_bin = model.trees.split_bin.copy()
    split_bin[0, 0] = 0 if split_bin[0, 0] > 3 else 14  # a much worse root split
    worse = model.trees._replace(split_bin=split_bin)
    result = gate(worse)
    assert result["violations"] >= 1
    with pytest.raises(AssertionError, match="beyond its bound"):
        chip_smoke.check_split_gate("classifier", result)


def test_nb_gate_catches_a_wrong_statistic(monkeypatch):
    x, y, _ = chip_smoke.higgs_workload(5000, 6, CPU, seed=6)
    good = chip_smoke.nb_phase(x[:4000], y[:4000], x[4000:], y[4000:], "gaussian", CPU)
    chip_smoke.check_nb("nb", good)
    nb_stats = chip_smoke.NBO.nb_stats

    def off(*args, **kwargs):
        st = nb_stats(*args, **kwargs)
        return st._replace(feat_sum=st.feat_sum * (1 + 1e-4))

    monkeypatch.setattr(chip_smoke.NBO, "nb_stats", off)
    bad = chip_smoke.nb_phase(x[:4000], y[:4000], x[4000:], y[4000:], "gaussian", CPU)
    with pytest.raises(AssertionError, match="off f64"):
        chip_smoke.check_nb("nb", bad)


def test_families_phase_on_cpu():
    """Phase 17 at a tiny size: every part runs and every gate holds."""
    higgs = chip_smoke.higgs_workload(20000, 6, CPU, seed=5)
    out = chip_smoke.phase_families(
        CPU, higgs, higgs_test_rows=4000, mnist_rows=3000, mnist_n=32, mnist_test_rows=500,
        gbt_stages=4, gbt_depth=3, gbt_gate_stages=(1, 2, 4), mlp_layers=(32, 16, 8, 10),
        mlp_max_iter=20, fm_max_iter=20, fm_parity_rows=4000, umap_epochs=30,
        umap_knn_sample=200, umap_trust_sample=500)
    for name in ("classifier", "regressor"):
        gbt = out["(a) gbt"][name]
        assert gbt["registry_refuses"] and gbt["final_F_rel_err_vs_f64"] <= 1e-6
        assert set(gbt["split_gates"]) == {1, 2, 4}
        assert all(g["violations"] == 0 and g["nodes_checked"] > 0
                   for g in gbt["split_gates"].values())
        fm = out["(c) fm"][name]
        assert fm["parity_steps"] == 10 and fm["first_steps_loss_max_rel_err"] <= 1e-6
    assert out["(a) gbt"]["regressor"]["loss_rises_beyond_rounding"] == 0
    assert out["(b) mlp"]["train_loss_rel_err"] <= 1e-6
    assert len(out["(b) mlp"]["first_losses"]["card"]) == 5
    umap = out["(d) umap"]
    assert umap["knn_gate"]["ids_outside_f64_top_k"] == 0 and umap["max_mass_rel_err"] <= 1e-5
    assert umap["same_seed_bit_equal"]  # the CPU's scatters add in edge order
    assert umap["deterministic_algorithms"]["bit_equal"]
    assert out["(e) one-vs-rest"]["mismatches_beyond_near_ties"] == 0
    assert out["(e) one-vs-rest"]["classes"] == 10


def test_trustworthiness_is_sklearns():
    from sklearn.manifold import trustworthiness

    rng = np.random.default_rng(2)
    x = rng.normal(size=(300, 12))
    emb = x[:, :2] + 0.3 * rng.normal(size=(300, 2))
    got = chip_smoke.trustworthiness(torch.from_numpy(x), torch.from_numpy(emb), 10)
    assert got == pytest.approx(trustworthiness(x, emb, n_neighbors=10), abs=1e-12)


def test_family_f64_oracles_are_the_port_functions_in_f64():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 9)).astype(np.float32)
    y = rng.integers(0, 4, size=200).astype(np.float64)
    layers = (9, 5, 4)
    flat = chip_smoke.PMLP.glorot_init(layers, 1, CPU, torch.float64)
    want = chip_smoke.PMLP.cross_entropy_loss(flat, torch.from_numpy(x).double(),
                                              torch.from_numpy(y).long(),
                                              torch.ones(200, dtype=torch.float64), layers)
    assert chip_smoke.mlp_loss_f64(flat.numpy(), x, y, layers) == pytest.approx(float(want),
                                                                              rel=1e-12)
    fm = rng.normal(size=1 + 9 + 9 * 3)
    want = chip_smoke.PFM.fm_score(torch.from_numpy(fm), torch.from_numpy(x).double(),
                                   n_feat=9, k=3).numpy()
    np.testing.assert_allclose(chip_smoke.fm_score_f64(fm, x, 9, 3, chunk=64), want,
                               rtol=1e-12, atol=1e-12)


def test_mnist_workload_is_seeded_with_ten_classes():
    x, y = chip_smoke.mnist_workload(500, 16, 10, CPU)
    x2, y2 = chip_smoke.mnist_workload(500, 16, 10, CPU)
    assert x.dtype == np.float32 and x.shape == (500, 16)
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(y, y2)
    assert set(np.unique(y)) == set(range(10))


def test_text_selection_phase_on_cpu():
    """Phase 18 (a) at a tiny size: the stages, the search and every gate."""
    out = chip_smoke.phase_text_selection(CPU, docs=300, classes=4, tokens=40, vocab=400,
                                          features=64, folds=2)
    assert out["tf_mismatches_vs_hashlib_counter"] == 0 and out["idf_equals_numpy_f64"]
    assert out["mismatches_beyond_near_ties"] == 0
    assert out["best_index"] == out["best_index_f64"]
    assert out["launches"] == {name: 0 for name in chip_smoke.KERNELS}


def test_adult_selection_phase_on_cpu():
    """Phase 18 (b) at a tiny size: 100 columns, numpy's one-hot, both
    searches within 1e-4 of the f64 fits."""
    out = chip_smoke.phase_adult_selection(CPU, rows=4000, folds=2)
    assert out["columns"] == 100 and out["one_hot_mismatches_vs_numpy"] == 0
    assert abs(out["positive_share"] - chip_smoke.ADULT_POSITIVE_SHARE) < 0.01
    assert out["cv"]["max_auc_err_vs_f64"] <= chip_smoke.TUNING_METRIC_TOL
    assert out["tvs"]["max_rmse_rel_err_vs_f64"] <= chip_smoke.TUNING_METRIC_TOL
    assert out["label_order"] == ["<=50K", ">50K"] and out["index_to_string_equal"]


def test_recovery_phases_on_cpu():
    """Phase 18 (c) and (d) at a tiny size: every plan recovers as gated."""
    data = chip_smoke.streamed_workload(64 * 30 + 17, 16, 3, CPU)
    out = chip_smoke.phase_recovery_streamed(data, CPU, k=4, chunk_rows=64, checkpoint_every=4,
                                             preempt_at=11, oom_at=6, io_at=(9, 14))
    runs = out["runs"]
    assert out["chunks"] == 31 and not out["failures"]
    assert runs["(i) preempt, resume"]["checkpoints"] == 2
    assert runs["(iii) oom"]["chunks"] == 5 + -(-(64 * 25 + 17) // 32)
    assert runs["(v) hang past the bound"]["raised"] == "FoldHangTimeout"
    res = chip_smoke.phase_recovery_resident(3200, 48, 4, 8, CPU)
    assert res["retry"]["retries"] == 1 and res["hedge"]["hedges"] == 1
    assert res["retry"]["pc_bit_equal"] and res["hedge"]["pc_bit_equal"]


def test_device_policy_phase_on_cpu():
    out = chip_smoke.phase_device_policy(CPU)
    assert out["probe_platform"] == "cpu" and out["subprocess_probe"]["state"] == "OK"
    assert out["faulted_inline_probe"]["state"] == "DEGRADED" and out["injected"] == 1


def test_column_frame_is_the_column_protocol():
    frame = chip_smoke.ColumnFrame({"x": np.arange(6.0).reshape(3, 2), "s": np.array(
        ["a", "b", "a"], dtype=object)})
    assert chip_smoke.columnar.has_named_columns(frame) and len(frame) == 3
    np.testing.assert_array_equal(chip_smoke.columnar.extract_matrix(frame, "x"),
                                  np.arange(6.0).reshape(3, 2))
    more = frame.assign(y=list(np.ones((3, 4))), t=[["a", "b"], ["c"], []])
    assert more["y"].to_numpy().shape == (3, 4) and list(more["t"].to_numpy()[1]) == ["c"]
    assert list(more.iloc[[2, 0]]["s"].to_numpy()) == ["a", "a"]


def test_cost_model_and_partition_bodies_phases_on_cpu():
    """Phase 19 (a) and (c) at a tiny size: the fit's linalg.gram_stats
    calls are its partitions, and the partition bodies' stats and
    projections agree with the fit and its transform."""
    a = chip_smoke.phase_cost_model(3000, 96, 5, 3, CPU)
    assert a["gram_stats"]["calls"] == 3 and a["padded_rows"] == 1024
    assert a["gram_stats"]["flops"] == chip_smoke.gram_cost_at(1024, 96)
    assert 0 < a["roofline_utilization"] <= chip_smoke.COST_ROOFLINE_MAX
    c = chip_smoke.phase_partition_bodies(3000, 96, 5, 3, CPU, a.pop("model"), a.pop("out"))
    assert c["launches"] == {name: 0 for name in chip_smoke.KERNELS}  # plain versions
    assert c["count"] == 3000 and c["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert c["transform_max_abs_err"] <= c["transform_tol"]


def test_cost_model_gate_catches_a_wrong_formula(monkeypatch):
    monkeypatch.setattr(chip_smoke, "gram_cost_at", lambda rows, n: 2.0 * rows * n * n)
    with pytest.raises(AssertionError, match="per-call flops"):
        chip_smoke.phase_cost_model(3000, 96, 5, 3, CPU)


def test_autotune_phase_on_cpu(monkeypatch):
    """Phase 19 (b) at a tiny size: the searched fit, then its cache hit,
    bit for bit; the in-process cache is empty afterwards."""
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "64")
    data = chip_smoke.streamed_workload(64 * 30 + 17, 16, 3, CPU)
    out = chip_smoke.phase_autotune(data, 4, 3, CPU)
    # the static chunk is bucketed to TPU_ML_MIN_BUCKET (128): {½, 1, 2}×128
    assert out["candidates"] == [64, 128, 256] and out["search_source"] == "search"
    assert out["winner_rows"] in out["candidates"] and 1 <= out["trials"] <= out["budget"]
    assert out["fold_chunks"] == -(-(64 * 30 + 17) // out["winner_rows"])
    assert out["cache_hit"] and out["pc_bit_equal"]
    assert set(out["seconds_per_row"]) == {64, 128, 256}
    assert chip_smoke.tuning_cache.entries() == {}


def test_every_phase_runs_unless_a_group_is_skipped():
    assert chip_smoke.parse_skip([]) == set()
    assert chip_smoke.parse_skip(["--skip", "ann,trees"]) == {"ann", "trees"}
    with pytest.raises(SystemExit):
        chip_smoke.parse_skip(["--skip", "kernels"])


def test_spark_glue_phase_on_cpu():
    """Phase 20 at a tiny size: every body over frames of named columns,
    every driver half, every gate; no kernel launches on the CPU."""
    c = chip_smoke.phase_spark_features(3000, 48, 3, 3, CPU)
    assert c["tsvd"]["launches"] == {name: 0 for name in chip_smoke.KERNELS}
    assert c["tsvd"]["count"] == 3000 and c["robust"]["hist_rows_per_feature"] == [3000]
    x_pool = chip_smoke.streamed_workload(4000, 32, 2, CPU)[0]
    a = chip_smoke.phase_spark_linear(x_pool, CPU, rows=3000, classes=3, partitions=3)
    assert len(a["binary"]["job_s"]) == len(a["softmax"]["job_s"]) == a["jobs"]
    assert a["logistic_transform"]["labels_equal"]
    b = chip_smoke.phase_spark_kmeans(CPU, rows=6000, n=16, k=20, partitions=3)
    assert b["sample"]["bodies_agree"] and b["sample"]["candidates"] > 0
    assert len(b["lloyd"]) == 3 and all(g["mismatches_not_near_tie"] == 0 for g in b["lloyd"])
    assert "spark" in chip_smoke.SKIPPABLE and chip_smoke.parse_skip(["--skip", "spark"]) == {
        "spark"}


def test_mesh_phase_on_cpu(monkeypatch):
    """Phase 21 at a tiny size on CPU shards: (a) the in-process programs,
    (b) the chunk fold on the mesh-local fit's own mesh and on four shards,
    (c) TSQR and the sketch, (d) the barrier bodies in two spawned gloo
    ranks; every gate, no kernel launches on the CPU."""
    x, gram = chip_smoke.streamed_workload(4096, 48, 4, CPU, seed=chip_smoke.MESH_SEED)
    a = chip_smoke.phase_mesh_inprocess(x, gram, 4, CPU, bins=8)
    assert a["launches"] == {name: 0 for name in chip_smoke.KERNELS}
    assert a["ranges_exact"] and a["histogram_exact"] and a["count"] == 4096
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "512")
    b = chip_smoke.phase_mesh_streamed((x, gram), 4, CPU)
    assert b["own_mesh"]["shards"] == 1 and b["four_shards"]["shards"] == 4
    assert b["own_mesh"]["chunks"] == b["chunks"] == 8 and b["degraded_cpu_fallback"] == 0
    c = chip_smoke.phase_mesh_tsqr_sketch(x[:2048], 4, CPU, oversample=60)  # l = n: the whole
    assert c["tsqr_min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    d = chip_smoke.phase_mesh_barrier(x[:1000], 4, CPU, ranks=2, frames=4)
    assert d["yielding_ranks"] == [0] and d["mesh_size"] == 2 and d["count"] == 1000
    assert "mesh" in chip_smoke.SKIPPABLE


# -- phase 22: the mesh fits -----------------------------------------------------


def test_meshfit_phase_on_cpu(linear_stream, monkeypatch):
    """Phase 22 at a tiny size on CPU shards: (a) the sharded linear
    statistics and the augmented per-shard fold, (b) the Newton programs
    against the core fits and the chunked resume, (c) k-means‖ and Lloyd
    with the resume, (d) sharded DBSCAN and kNN, (e) the sharded forest and
    NaiveBayes statistics, (f) the IVF index's mesh Lloyd fold, (g) the four
    fit bodies in two spawned gloo ranks; every gate, no kernel launches."""
    x, gram = linear_stream
    linreg = chip_smoke.phase_streamed_linreg((x, gram), 4, CPU)
    a = chip_smoke.phase_meshfit_linear(x, linreg, CPU, rows=2000)
    assert a["fold_chunks"] == 6 and a["fold_rel_vs_one_device"] <= chip_smoke.MESH_STATS_TOL
    b = chip_smoke.phase_meshfit_newton(x, CPU, rows=2000, classes=3, partitions=3)
    assert b["resume"]["equal_to_uninterrupted"] and b["resume"]["iterations"] == 6
    c = chip_smoke.phase_meshfit_kmeans(CPU, rows=6000, n=16, k=12, iters=3, partitions=3)
    assert c["init"]["count_total"] == 6000 and c["fit_equals_the_stepwise_loop"]
    d = chip_smoke.phase_meshfit_distance(CPU, grids=4, side=6, n=16, knn_rows=3000,
                                          knn_queries=50, k=5)
    assert d["dbscan"]["label_mismatches"] == 0
    higgs = chip_smoke.higgs_workload(8000, 6, CPU, seed=5)
    e = chip_smoke.phase_meshfit_trees_nb(higgs, CPU, rows=6000, trees=2, nb_rows=3000, nb_n=32,
                                          classes=4)
    assert e["forest"]["differing_fields"] == [] and e["naive_bayes"]["counts_exact"]
    f = chip_smoke.phase_meshfit_ann(CPU, rows=9000, chunk=4000, n=8, clusters=20)
    assert f["nlist"] == 94
    g = chip_smoke.phase_meshfit_barrier(x, linreg, CPU, rows=2000, ranks=2, frames=4)
    assert all(v == [0] for v in g["yielding_ranks"].values())
    parts = dict(linear=a, newton=b, kmeans=c, distance=d, trees_nb=e, ann=f, barrier=g)
    for name in chip_smoke.KERNELS:
        launches = chip_smoke._meshfit_launches(parts, name)
        assert len(launches) == 8 and set(launches.values()) == {0}
    assert "meshfit" in chip_smoke.SKIPPABLE
