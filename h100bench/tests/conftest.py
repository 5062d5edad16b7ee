"""Helpers of the benchmark's own tests: each cell cut to a size the CPU
runs in a second or two (the harness's look for a card is skipped by
calling ``run.run_cell`` with the CPU device)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

from h100bench import hygiene, spec  # noqa: E402

#: per configuration, what the CPU runs: fewer rows and partitions, and
#: KMeans with k = 20 centres
TINY = {
    "kmeans-c5": {"rows": 20_000, "partitions": 3, "k": 20},
}


def shrink(config: dict, rows=None, partitions=None, k=None) -> dict:
    c = copy.deepcopy(config)
    if rows is not None:
        c["rows"] = c["data"]["rows"] = rows
    if partitions is not None:
        c["partitions"] = c["data"]["partitions"] = partitions
        for op in c["operations"].values():
            if "num_partitions" in op.get("args", {}):
                op["args"]["num_partitions"] = partitions
    if k is not None:
        c["k"] = c["params"]["k"] = c["data"]["centres"] = k
    return c


def tiny_cell(name: str, root: Path | None = None) -> spec.Cell:
    """The cell ``name`` at its CPU size, its environment set."""
    cell = spec.load_cell(name, CHECKOUT if root is None else root)
    cell.config = shrink(cell.config, **TINY[cell.config["name"]])
    hygiene.prepare_environment(cell.config, CHECKOUT)
    return cell


@pytest.fixture
def knobs_restored():
    """Undo the environment a tiny cell sets."""
    import os

    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


@pytest.fixture
def cuda_device():
    """The card, or a skip where none is (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with -m cuda")
    return torch.device("cuda", 0)
