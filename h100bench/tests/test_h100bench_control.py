"""The control and the planted faults on the card: a checked fit of the
program reads under every limit; the control (the reference's Lloyd step
in TF32, the precision below the configuration's f32) and each fault that
the cell's numbers catch read over one of them. At the cell's own size (a
KMeans limit holds at the size it was set from), on one seed: about five
minutes on the card. ``python3 -m h100bench.calibrate`` reads the same on
many seeds."""

from __future__ import annotations

import pytest

from h100bench import calibrate, hygiene, spec

CELLS = ["kmeans-c5.fit"]
CAUGHT = ["kmeans_half_batch", "kmeans_seeding_stuck"]


def _within(numbers: dict, limits: dict) -> bool:
    return all(numbers[name] <= limit for name, limit in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_passes_and_the_control_and_faults_fail(name, cuda_device, knobs_restored):
    cell = spec.load_cell(name)
    hygiene.prepare_environment(cell.config, spec.HERE.parent)
    seeds = [3_000_000_017]
    entries = calibrate.readings(cell, seeds, seeds, CAUGHT, seeds, cuda_device)
    assert {e["side"] for e in entries} == {"sound", "control", *CAUGHT}
    limits = cell.config["limits"]
    for e in entries:
        assert _within(e["numbers"], limits) == (e["side"] == "sound"), e
