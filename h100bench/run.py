"""One run of one benchmark cell on one card.

    python3 -m h100bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name (``spec.py``); this file knows none of
them. A run:

1. sets the environment the configuration pins and the caches inside the
   checkout, before torch or the program is imported;
2. makes the inputs on the card from the seed into pageable host arrays,
   then warms up with one whole operation, checked where the configuration
   says so: it keeps the state the reference follows (both count as
   set-up);
3. drives the traffic mix for ``--seconds`` (``loadgen.py``; under
   ``--trace 1`` a few whole operations run under the profiler);
4. reads the device's memory peak, frees the program's state, runs the
   plain reference over every completed operation's answer and compares
   each number with its limit;
5. prints the numbers compared on standard error and, as the last line of
   standard output, one JSON object: ``correct``, ``attempted``,
   ``failed``, ``metrics``, ``device``, under ``--trace 1`` ``breakdown``,
   then ``card`` and, last, ``checks``.

It exits non-zero and prints no result where no card is present, where a
set-up step fails, or where JAX or the JAX package is loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

if __package__ in (None, ""):  # run as a file: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import hygiene, spec  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


@dataclass
class Context:
    """What the metric readers see."""

    config: dict
    setup_s: float
    records: list = field(default_factory=list)
    events: list | None = None


def card_info(device) -> dict:
    """The card's name (torch) and power limit (``nvidia-smi``)."""
    import torch

    if device.type != "cuda":
        return {"kind": "cpu", "nvidia_smi": "none"}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "unknown"
    return {"kind": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def judge(cell, ref, prepared, records, checked) -> tuple[dict, int]:
    """(checks: worst value and limit of each number over the completed
    operations, the number of operations that failed or read over a
    limit). ``checked`` is the checked warm-up's answer."""
    limits = cell.config["limits"]
    worst: dict = {name: None for name in limits}
    failed = 0
    for rec in records:
        if not rec.ok:
            failed += 1
            continue
        numbers = ref.judge(cell.config, prepared, rec.output, checked)
        bad = False
        for name, limit in limits.items():
            value = float(numbers[name])
            if math.isnan(value):
                worst[name] = "nan"
            elif worst[name] != "nan":
                worst[name] = value if worst[name] is None else max(worst[name], value)
            bad |= not value <= limit
        failed += bad
    return {name: {"value": worst[name], "limit": limits[name]} for name in limits}, failed


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """One run of ``cell`` on ``device``; returns the result object."""
    import torch

    from h100bench import loadgen
    from h100bench import trace as tr
    from h100bench.reference import data
    from h100bench.system import System, estimator_class

    estimator_class(cell.config["estimator"])  # the program is there, before any data
    cuda = device.type == "cuda"
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config = cell.config
    card = card_info(device)
    scratch = tempfile.mkdtemp(prefix="h100bench-")
    try:
        x = data.make(config["data"], seed, device)
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        system = System(config, seed, device, x, scratch)
        op = system.operation(cell.traffic["op"], cell.traffic)
        # the warm-up, every shape the window uses: a checked call where the
        # operation has one, whose state the reference follows
        checked = op(0, check=True)
        ctx = Context(config, setup_s=time.perf_counter() - t_process)
        tracer = tr.Tracer() if trace else None
        ctx.records = loadgen.drive(op, seconds, cell.traffic, seed, tracer)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        if tracer is not None:
            ctx.events = tracer.events
        del system, op
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        metrics = {}
        for m in (cell.per_layer if trace else cell.end_to_end):
            value = spec.metric_reader(m["name"], cell.bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

        ref = spec.reference(config["reference"], cell.bench_dir)
        checks, failed = judge(cell, ref, ref.prepare(config, x, device, seed), ctx.records,
                               checked)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    print("op seconds: " + " ".join(f"{r.end - r.start:.4f}" for r in ctx.records),
          file=sys.stderr)
    errors = [r.error for r in ctx.records if not r.ok]
    for err in errors[:3]:
        print(err, file=sys.stderr)
    result = {
        "correct": failed == 0 and bool(ctx.records),
        "attempted": len(ctx.records),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": card["kind"],
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if trace:
        summary = tr.summary(ctx.events or [])
        result["device"]["busy_s"] = summary.get("busy_s", 0.0)
        result["device"]["window_s"] = summary.get("window_s", 0.0)
        if "breakdown" in summary:
            result["breakdown"] = summary["breakdown"]
    result["card"] = card
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_process = hygiene.process_start()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = spec.load_cell(args.workload, CHECKOUT)
    hygiene.prepare_environment(cell.config, CHECKOUT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_process)

    if args.trace:
        for name, secs in result.get("breakdown", {}).get("device_ops", []):
            print(f"device op {secs:.6f} s: {name}", file=sys.stderr)
    loaded = hygiene.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
