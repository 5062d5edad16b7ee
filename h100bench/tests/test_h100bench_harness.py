"""The harness on the CPU: discovery by name (a configuration, a traffic
mix, a cell and a metric added as new files alone), the window's
arithmetic, the roofline, MFU and share arithmetic from shapes and
synthetic events, and the last line's schema."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import CHECKOUT, TINY, shrink, tiny_cell
from h100bench import hygiene, loadgen, run, spec, trace, work

BENCH = CHECKOUT / "h100bench"


# -- discovery ---------------------------------------------------------------

def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy_of_checkout(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_every_cell_and_metric_resolves():
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    assert {w["name"] for w in bench["workloads"]} == {"kmeans-c5.fit"}
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["op"] in cell.config["operations"]
        assert cell.end_to_end and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert spec.reference(cell.config["reference"]).judge


def _add_small_config(root: Path) -> None:
    config = shrink(json.loads((root / "h100bench/configs/kmeans-c5.json").read_text()),
                    **TINY["kmeans-c5"])
    config["name"] = "kmeans-small"
    config["operations"]["predict"] = {"on": "fit", "call": "transform", "input": "batch"}
    (root / "h100bench/configs/kmeans-small.json").write_text(json.dumps(config))


def _register(root: Path, cell: str, traffic: str, metric: str, unit: str, moves: str) -> None:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if not any(c["name"] == "kmeans-small" for c in bench["configs"]):
        bench["configs"].append({"name": "kmeans-small", "source": "test", "reduced": [],
                                 "file": "h100bench/configs/kmeans-small.json", "why": "test"})
    bench["workloads"].append({"name": cell, "config": "kmeans-small",
                               "traffic": traffic, "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": metric, "unit": unit, "better": "higher",
                               "source": "host_clock", "layer": "estimator",
                               "moves": moves, "workloads": [cell]})
    for m in bench["end_to_end"]:
        if m["name"] == moves:
            m.setdefault("workloads", []).append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_new_cell_config_traffic_and_metric_are_new_files_alone(copy_of_checkout, knobs_restored):
    root = copy_of_checkout
    before = _digests(root / "h100bench")
    _add_small_config(root)
    mix = json.loads((root / "h100bench/traffic/fit.json").read_text())
    (root / "h100bench/traffic/refit.json").write_text(json.dumps({**mix, "trace_ops": 2}))
    (root / "h100bench/metrics/fits_done.py").write_text(
        "def read(ctx):\n    return float(sum(r.ok for r in ctx.records))\n")
    _register(root, "kmeans-small.refit", "refit", "fits_done", "fits", "kmeans_fit_s")
    after = _digests(root / "h100bench")
    assert {k: v for k, v in after.items() if k in before} == before  # no file edited

    cell = spec.load_cell("kmeans-small.refit", root)
    hygiene.prepare_environment(cell.config, root)
    assert cell.bench_dir == root / "h100bench" and cell.traffic["trace_ops"] == 2
    assert [m["name"] for m in cell.per_layer] == ["fits_done"]
    assert [m["name"] for m in cell.end_to_end] == ["kmeans_fit_s", "setup_s"]
    res = run.run_cell(cell, 7, 0.1, True, torch.device("cpu"), 0.0)
    assert res["correct"] and res["metrics"]["fits_done"]["value"] == res["attempted"]


def test_a_new_loop_operation_metric_and_reference_are_new_files_alone(copy_of_checkout,
                                                                     knobs_restored):
    """An open loop of batch predictions on a model fitted in set-up, with
    its own end-to-end metric and reference: files and entries only."""
    root = copy_of_checkout
    before = _digests(root / "h100bench")
    _add_small_config(root)
    config = json.loads((root / "h100bench/configs/kmeans-small.json").read_text())
    config["reference"], config["limits"] = "batch_rows", {"rows_off": 0}
    (root / "h100bench/configs/kmeans-small.json").write_text(json.dumps(config))
    (root / "h100bench/traffic/predict-open.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 400, "arrival": "poisson", "op": "predict",
         "batch_rows": 256}))
    (root / "h100bench/metrics/predict_p95_ms.py").write_text(
        "import numpy as np\n\n\ndef read(ctx):\n"
        "    lat = [r.end - r.arrival for r in ctx.records if r.ok]\n"
        "    return float(np.percentile(lat, 95) * 1e3) if lat else None\n")
    (root / "h100bench/reference/batch_rows.py").write_text(
        "def prepare(config, x, device, seed):\n    return {}\n\n\n"
        "def judge(config, prepared, output, checked):\n"
        "    return {'rows_off': abs(len(output['value']) - 256)}\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "predict_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock", "workloads": []})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "h100bench/metrics/requests_done.py").write_text(
        "def read(ctx):\n    return float(sum(r.ok for r in ctx.records))\n")
    _register(root, "kmeans-small.predict", "predict-open", "requests_done", "requests",
              "predict_p95_ms")
    after = _digests(root / "h100bench")
    assert {k: v for k, v in after.items() if k in before} == before  # no file edited

    cell = spec.load_cell("kmeans-small.predict", root)
    hygiene.prepare_environment(cell.config, root)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "predict_p95_ms"]
    res = run.run_cell(cell, 2**31 + 5, 0.5, False, torch.device("cpu"), 0.0)
    assert res["correct"] and res["checks"]["rows_off"]["value"] == 0
    assert res["attempted"] == len(loadgen.arrivals(cell.traffic, 0.5, 2**31 + 5)) > 100
    assert res["metrics"]["predict_p95_ms"]["value"] > 0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")


# -- the window -------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_closed_loop_counts_the_operation_that_overruns():
    clock = FakeClock()

    def op(i):
        clock.t += 3.0
        return {"i": i}

    recs = loadgen.drive(op, 10.0, {"loop": "closed"}, clock=clock)
    assert [r.start for r in recs] == [0.0, 3.0, 6.0, 9.0]  # the fourth starts at 9 < 10
    assert [r.output["i"] for r in recs] == [0, 1, 2, 3]
    assert loadgen.seconds_per_op(recs) == 12.0 / 4


def test_failed_operations_are_counted_and_left_out_of_the_rate():
    clock = FakeClock()

    def op(i):
        clock.t += 2.0
        if i == 1:
            raise RuntimeError("planted")
        return {}

    recs = loadgen.drive(op, 5.0, {"loop": "closed"}, clock=clock)
    assert [r.ok for r in recs] == [True, False, True]
    assert "planted" in recs[1].error
    assert loadgen.seconds_per_op(recs) == 6.0 / 2


class FakeTracer:
    def __init__(self):
        self.log = []

    def start(self):
        self.log.append("start")

    def stop(self):
        self.log.append("stop")

    def op_range(self):
        import contextlib

        self.log.append("op")
        return contextlib.nullcontext()


def test_traced_operations_run_whole_even_past_the_window():
    clock = FakeClock()

    def op(i):
        clock.t += 4.0
        return {}

    tracer = FakeTracer()
    recs = loadgen.drive(op, 1.0, {"loop": "closed", "trace_skip_ops": 1, "trace_ops": 2},
                         tracer=tracer, clock=clock)
    assert [r.traced for r in recs] == [False, True, True]
    assert tracer.log == ["start", "op", "op", "stop"]


def test_open_loop_serves_every_arrival_in_order():
    clock = FakeClock()

    def sleep(s):
        clock.t += s

    def op(i):
        clock.t += 0.15 if i == 2 else 0.05  # the third overruns the next arrival
        return {}

    mix = {"loop": "open", "rate_per_s": 5, "arrival": "uniform", "trace_ops": 1}
    tracer = FakeTracer()
    recs = loadgen.drive(op, 1.0, mix, tracer=tracer, clock=clock, sleep=sleep)
    assert [r.arrival for r in recs] == pytest.approx([0.0, 0.2, 0.4, 0.6, 0.8])
    assert [r.start for r in recs] == pytest.approx([0.0, 0.2, 0.4, 0.6, 0.8])
    assert recs[2].end - recs[2].arrival == pytest.approx(0.15)
    assert tracer.log == ["start", "op", "stop"] and recs[0].traced
    poisson = loadgen.arrivals({"rate_per_s": 50}, 10.0, 2**31 + 3)
    assert (np.diff(poisson) > 0).all() and poisson[-1] < 10.0 and 400 < len(poisson) < 600
    np.testing.assert_array_equal(poisson, loadgen.arrivals({"rate_per_s": 50}, 10.0, 2**31 + 3))


def test_unknown_loops_and_several_callers_are_refused():
    with pytest.raises(ValueError):
        loadgen.drive(dict, 1.0, {"loop": "burst"})
    with pytest.raises(ValueError):
        loadgen.drive(dict, 1.0, {"loop": "closed", "clients": 2})


# -- arithmetic from shapes and events ---------------------------------------

def E(kind, name, start, end):
    return trace.Event(kind, name, float(start), float(end))


def synthetic_events():
    # a traced window of 1 s (µs) holding two operations; two Gram kernels of
    # 100 ms, one other kernel of 50 ms overlapping a copy of 200 ms, an
    # eigensolver's GEMM, and the device-side mirror of the harness's range
    return [
        E("op", trace.OP_RANGE, 0, 500_000), E("op", trace.OP_RANGE, 500_000, 1_000_000),
        E("kernel", "gram_partial_kernel<true, 3>", 100_000, 200_000),
        E("kernel", "gram_reduce_kernel", 600_000, 700_000),
        E("kernel", "elementwise_kernel", 250_000, 300_000),
        E("h2d", "Memcpy HtoD (Pinned -> Device)", 200_000, 400_000),
        E("op", "aten::linalg_eigh", 800_000, 900_000),
        E("runtime", "cudaLaunchKernel", 850_000, 851_000),
        E("kernel", "sm90_xmma_gemm_f32f32", 900_000, 950_000),
        E("annotation", trace.OP_RANGE, 0, 1_000_000),
        E("op", "aten::copy_", 300_000, 550_000),
        E("kernel", "before the window", -10, -5),
    ]


def test_window_busy_idle_and_copy_shares():
    ev = synthetic_events()
    assert trace.window(ev) == (0.0, 1_000_000.0)
    # busy: 100–400 ms (kernels and the copy), 600–700, 900–950 ms
    assert trace.busy_share(ev) == pytest.approx(0.45)
    assert trace.busy_share(ev, kinds=("h2d",)) == pytest.approx(0.2)
    gaps = trace.idle_gaps(ev)
    assert gaps[0] == (0.0, 100_000.0) and gaps[-1] == (950_000.0, 1_000_000.0)
    assert sum(b - a for a, b in gaps) == pytest.approx(550_000)
    labels = dict(trace.idle_by_host(ev))
    assert labels["aten::copy_"] == pytest.approx(0.2)  # 400–600 ms, labelled at 500
    assert labels["aten::linalg_eigh"] == pytest.approx(0.2)  # 700–900 ms, at 800
    assert labels["host python"] == pytest.approx(0.15)
    summary = trace.summary(ev)
    assert summary["busy_s"] == pytest.approx(0.45) and summary["window_s"] == pytest.approx(1.0)
    assert summary["breakdown"]["device_ops"][0][0] == "Memcpy HtoD (Pinned -> Device)"


class Rec:
    def __init__(self, start, end, traced=False, ok=True):
        self.start, self.end, self.traced, self.ok = start, end, traced, ok


def ctx_for(config, events, records):
    return run.Context(config, setup_s=1.0, records=records, events=events)


def test_lloyd_roofline_and_kmeans_mfu():
    config = {"rows": 5_000_000, "n": 128, "params": {"k": 1000, "maxIter": 20}}
    per_fit = work.lloyd_bound_s(5_000_000, 128, 1000, 20)
    assert per_fit == pytest.approx(20 * 4 * 5e6 * 128 * 1000 / 67e12)  # 0.764 s
    recs = [Rec(0, 4, traced=True), Rec(4, 7), Rec(7, 11)]
    ev = synthetic_events()
    # every kernel in the window, whatever its name: 0.3 s of union
    assert spec.metric_reader("lloyd_roofline")(ctx_for(config, ev, recs)) == pytest.approx(
        100 * per_fit / 0.3)
    assert spec.metric_reader("kmeans_fit_mfu")(ctx_for(config, ev, recs)) == pytest.approx(
        100 * 2 * per_fit / 7.0)


def test_readers_that_find_nothing_return_nothing():
    config = {"rows": 10, "n": 4, "params": {"k": 2, "maxIter": 1}}
    no_kernels = [e for e in synthetic_events() if e.kind != "kernel"]
    assert spec.metric_reader("lloyd_roofline")(ctx_for(config, no_kernels, [Rec(0, 1, True)])) is None
    assert spec.metric_reader("lloyd_roofline")(ctx_for(config, None, [Rec(0, 1, True)])) is None
    assert spec.metric_reader("idle_share.kmeans_fit")(ctx_for(config, [], [])) is None
    assert spec.metric_reader("kmeans_fit_mfu")(ctx_for(config, None, [Rec(0, 1, True)])) is None


# -- the last line ------------------------------------------------------------

@pytest.mark.parametrize("name", ["kmeans-c5.fit"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_schema(name, traced, knobs_restored):
    cell = tiny_cell(name)
    res = run.run_cell(cell, 2**31 + 11, 0.2, traced, torch.device("cpu"), 0.0)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown"] if traced else []
    assert list(res) == keys + ["card", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    wanted = cell.per_layer if traced else cell.end_to_end
    for name_, entry in res["metrics"].items():
        assert {m["name"]: m["unit"] for m in wanted}[name_] == entry["unit"]
        assert isinstance(entry["value"], float)
    if not traced:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    device = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(device)
    assert ("busy_s" in device and "window_s" in device) == traced
    for check in res["checks"].values():
        assert check["value"] <= check["limit"]
    json.dumps(res, allow_nan=False)


def test_no_card_no_result(tmp_path):
    """Without a card the command exits non-zero and prints nothing on
    standard output (this sandbox has none)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", "kmeans-c5.fit",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=CHECKOUT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_the_device_mirror_of_the_range_is_no_device_work():
    cuda = torch.autograd.DeviceType.CUDA
    assert trace._event(trace.OP_RANGE, cuda, 0, 1).kind == "annotation"
    assert trace._event("Memcpy HtoD (Pageable -> Device)", cuda, 0, 1).kind == "h2d"
    assert trace._event("gram_reduce_kernel", cuda, 0, 1).kind == "kernel"
    assert trace._event(trace.OP_RANGE, torch.autograd.DeviceType.CPU, 0, 1).kind == "op"
    assert trace._event("cudaLaunchKernel", torch.autograd.DeviceType.CPU, 0, 1).kind == "runtime"
