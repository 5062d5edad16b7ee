"""Discovery by name. ``BENCHMARK.json`` at the checkout's root names every
cell, configuration, traffic mix and metric; each of them lives in a file
of its own that this module finds from that name:

- a configuration: the ``file`` its ``configs`` entry gives (JSON);
- a traffic mix: ``traffic/<traffic>.json``;
- a metric, end-to-end or per-layer: ``metrics/<name>.py``, a module with
  ``read(ctx)`` that returns a number, or None where it finds nothing;
- a reference: ``reference/<reference>.py``, named by the configuration.

So a later cell, configuration or metric is added as new files and a new
entry, with no edit to a file that is here. This module imports neither
torch nor the program: the harness reads the specification before it sets
the environment up.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    bench_dir: Path = HERE


def _applies(metric: dict, cell: str, e2e_names: set[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` (root: the checkout
    holding this folder), with its configuration, traffic mix and the
    metrics it reports."""
    root = HERE.parent if root is None else Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    bench_dir = root / bench["paths"][0]
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name, int(cell["chips"]), config, traffic, e2e, per_layer, bench_dir)


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, bench_dir: Path = HERE):
    """``read`` of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    return _load_file(path, f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}").read


def reference(name: str, bench_dir: Path = HERE):
    """The module ``reference/<name>.py``."""
    path = bench_dir / "reference" / f"{name}.py"
    return _load_file(path, f"h100bench_reference_{name.replace('-', '_')}")
