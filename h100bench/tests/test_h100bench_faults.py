"""A whole run on the CPU, the look for a card skipped, with the timed path
broken underneath (``h100bench/faults.py``): each fault the cell can have
must turn ``correct`` false. The sound run beside them must stay correct.
A seeding that draws uniformly is not among them: on the cell's blobs it
reads as a sound seeding does (PERF.md)."""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu_torch.models.kmeans as kmeans_model
from conftest import tiny_cell
from h100bench import faults, run, spec
from h100bench.reference import data
from h100bench.system import System

CELL = "kmeans-c5.fit"
CAUGHT = ["kmeans_state_unchanged", "kmeans_half_batch", "kmeans_answer_altered",
          "kmeans_seeding_stuck"]


def _run(seconds=0.1):
    return run.run_cell(tiny_cell(CELL), 424242, seconds, False, torch.device("cpu"), 0.0)


def test_sound_run_is_correct(knobs_restored):
    res = _run()
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("fault", CAUGHT)
def test_fault_turns_correct_false(fault, monkeypatch, knobs_restored):
    faults.FAULTS[fault](monkeypatch.setattr)
    res = _run()
    assert not res["correct"] and res["failed"] == res["attempted"], res["checks"]
    assert any(not (c["value"] != "nan" and c["value"] <= c["limit"])
               for c in res["checks"].values())


def test_a_timed_fit_that_differs_from_the_checked_one_fails(monkeypatch, knobs_restored):
    """The reference follows the checked warm-up fit; a timed fit whose
    answer differs from it by a bit fails on ``same``."""
    orig = kmeans_model.KMeansModel.__init__
    calls = []

    def every_other(self, *a, clusterCenters=None, **kw):
        calls.append(1)
        c = np.array(clusterCenters)
        if len(calls) % 2 == 0:
            c[0, 0] = np.nextafter(c[0, 0], np.inf)  # one bit of one coordinate
        orig(self, *a, clusterCenters=c, **kw)

    monkeypatch.setattr(kmeans_model.KMeansModel, "__init__", every_other)
    res = _run(0.3)
    assert not res["correct"] and 0 < res["failed"] < res["attempted"] + 1
    assert res["checks"]["same"]["value"] > 0 == res["checks"]["same"]["limit"]


def test_every_step_of_the_checked_fit_is_kept_and_judged(knobs_restored):
    """The program keeps its two newest checkpoints; the harness keeps every
    step it published, and the reference follows each."""
    cell = tiny_cell(CELL)
    x = data.make(cell.config["data"], 5, torch.device("cpu"))
    with tempfile.TemporaryDirectory() as scratch:
        op = System(cell.config, 5, torch.device("cpu"), x, scratch).operation("fit", cell.traffic)
        out = op(0, check=True)
        ref = spec.reference("kmeans")
        steps = ref.checkpoints(out["state_dir"])
        names = sorted(p.name for p in Path(out["state_dir"]).glob("step-*"))
        assert names == [f"step-{i:09d}" for i in range(len(names))] and len(names) > 6
        np.testing.assert_array_equal(steps[-1][0], out["clusterCenters"])
        assert steps[-1][1] == out["trainingCost"]
        prepared = ref.prepare(cell.config, x, torch.device("cpu"), 5)
        numbers = ref.judge(cell.config, prepared, out, out)
        assert set(numbers) == set(cell.config["limits"])
        assert all(numbers[k] <= v for k, v in cell.config["limits"].items()), numbers
        # a middle step altered on disk fails centre_rms and cost_gap
        broken = dict(out, state_dir=scratch + "/broken")
        shutil.copytree(out["state_dir"], broken["state_dir"])
        mid = sorted(Path(broken["state_dir"]).glob("step-*"))[5]
        with np.load(mid / "arrays.npz") as z:
            centres = np.array(z["centers"])
        centres[3] += 0.5
        np.savez(mid / "arrays.npz", centers=centres)
        state = json.loads((mid / "state.json").read_text())
        state["cost"] *= 1.01
        (mid / "state.json").write_text(json.dumps(state))
        bad = ref.judge(cell.config, prepared, broken, broken)
        assert bad["centre_rms"] > cell.config["limits"]["centre_rms"]
        assert bad["cost_gap"] > cell.config["limits"]["cost_gap"]
