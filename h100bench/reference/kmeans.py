"""Plain reference of a KMeans fit on blobs, in f64.

A k-means++ seeding draws from a generator of the program's own, so no
independent reference reproduces a fit's seeds. The reference judges the
rest of the trajectory step by step, and the whole of it by the quality
of its answer. The run's warm-up fit, the checked fit, writes a checkpoint
of its centres and cost at every Lloyd iteration (``checkpoint_every`` 1);
the timed fits write nothing. Four numbers are compared for each timed fit:

- ``centre_rms``: for every step t ≥ 1 of the checked fit, the centres
  C_t against the f64 Lloyd step from C_{t-1} (every row assigned in f64,
  the f64 means of the clusters): the root mean square over clusters of
  ‖C_t − f64 centre‖ over the median f64 centre norm, the largest over the
  steps. The last step's C_t is the timed fit's answer;
- ``cost_gap``: for every step t ≥ 1, |the program's cost of C_{t-1} (the
  checkpoint's, and for the last step the timed fit's ``trainingCost``) /
  its f64 cost − 1|, the largest over the steps;
- ``excess_cost``: the f64 cost of the answer over the f64 cost of the
  centres the blobs were drawn around, − 1: the quality of the whole
  trajectory, seeding included, from the inputs alone;
- ``same``: the largest |timed − checked| of the centres and of
  ``trainingCost``. The fit is deterministic (ordered sums, a seeded
  generator on the card), so every timed fit returns the checked fit's
  answer bit for bit: limit 0.

The control is the last step computed from the same input centres in f32
with both products in TF32, the precision below the configuration's f32
(``control_output``).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from h100bench.reference import data

#: rows per block of a pass: a [block, k] f64 tile of 0.5 GB at k=1000
BLOCK_ROWS = 65_536


def prepare(config: dict, x: np.ndarray, device: torch.device, seed: int) -> dict:
    """The rows on ``device`` once, in f32 as handed to the fit (each block is
    widened to f64 as it is used), and the f64 cost of the blobs' own
    centres."""
    spec = config["data"]
    assert spec["maker"] == "blobs", spec
    rows = torch.from_numpy(x).to(device)
    truth = data.blob_centres(spec["n"], spec["centres"], seed, device)
    truth_cost = assign_pass(rows, truth, torch.float64)[2]
    return {"x": rows, "truth_cost": truth_cost, "fits": {}, "costs": {}}


def assign_pass(x: torch.Tensor, centres: torch.Tensor, dtype: torch.dtype,
                tf32: bool = False) -> tuple[torch.Tensor, torch.Tensor, float]:
    """(sums [k, n], counts [k], cost) in ``dtype`` of assigning every row of
    ``x`` to its first nearest centre: squared distances by the expansion
    ‖x‖² + ‖c‖² − 2·x·cᵀ, clamped at 0. ``tf32``: both products in TF32."""
    k, n = centres.shape
    c = centres.to(dtype)
    c_sq = (c * c).sum(1)
    sums = torch.zeros((k, n), dtype=dtype, device=x.device)
    counts = torch.zeros(k, dtype=dtype, device=x.device)
    cost = torch.zeros((), dtype=dtype, device=x.device)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for lo in range(0, x.shape[0], BLOCK_ROWS):
            xb = x[lo:lo + BLOCK_ROWS].to(dtype)
            d = ((xb * xb).sum(1, keepdim=True) + c_sq[None, :]).sub_(xb @ c.T, alpha=2.0)
            best, labels = torch.min(d.clamp_(min=0.0), dim=1)
            cost += best.sum()
            onehot = torch.zeros((xb.shape[0], k), dtype=dtype, device=x.device)
            onehot.scatter_(1, labels[:, None], 1.0)
            sums += onehot.T @ xb
            counts += onehot.sum(0)
            del d, onehot
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return sums, counts, float(cost)


def lloyd_step(x: torch.Tensor, centres: torch.Tensor, dtype: torch.dtype,
               tf32: bool = False) -> tuple[torch.Tensor, float]:
    """(new centres [k, n], cost of ``centres``) of one Lloyd step over every
    row of ``x``; an empty cluster keeps its centre."""
    sums, counts, cost = assign_pass(x, centres, dtype, tf32)
    c = centres.to(dtype)
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, c), cost


def checkpoints(state_dir: str) -> list[tuple[np.ndarray, float]]:
    """(centres, cost) of every step the checked fit wrote
    (``<dir>/step-<n>/arrays.npz`` key ``centers``, ``state.json`` key
    ``cost``), in order of step."""
    out = []
    steps = sorted(Path(state_dir).glob("step-*"), key=lambda p: int(p.name.split("-")[1]))
    for step in steps:
        with np.load(step / "arrays.npz") as arrays:
            centres = np.array(arrays["centers"])
        out.append((centres, float(json.loads((step / "state.json").read_text())["cost"])))
    return out


def trajectory(prepared: dict, checked: dict) -> dict:
    """The f64 side of the checked fit's steps, worked out once for all the
    fits judged against it: the largest ``centre_rms`` and ``cost_gap`` of
    the steps before the last, and the f64 last step."""
    key = checked["state_dir"]
    if key not in prepared["fits"]:
        x = prepared["x"]
        steps = checkpoints(key)
        rms, gaps = [0.0], [0.0]
        last = None
        for t in range(1, len(steps)):
            prev = torch.from_numpy(steps[t - 1][0]).to(x.device)
            ref, ref_cost = lloyd_step(x, prev, torch.float64)
            if t == len(steps) - 1:
                last = (prev, ref, ref_cost)
                break
            rms.append(centre_rms(steps[t][0], ref))
            gaps.append(abs(steps[t][1] / ref_cost - 1.0))
        prepared["fits"][key] = {"rms": max(rms), "cost_gap": max(gaps), "last": last}
    return prepared["fits"][key]


def centre_rms(got: np.ndarray, ref: torch.Tensor) -> float:
    got = torch.from_numpy(np.asarray(got, np.float64)).to(ref.device)
    gaps = (got - ref).norm(dim=1)
    return float(gaps.square().mean().sqrt() / ref.norm(dim=1).median())


def answer_cost(prepared: dict, centres: np.ndarray) -> float:
    """The f64 cost of ``centres``, worked out once for equal answers."""
    key = hashlib.sha256(np.ascontiguousarray(centres).tobytes()).hexdigest()
    if key not in prepared["costs"]:
        c = torch.from_numpy(np.array(centres)).to(prepared["x"].device)
        prepared["costs"][key] = assign_pass(prepared["x"], c, torch.float64)[2]
    return prepared["costs"][key]


def judge(config: dict, prepared: dict, output: dict, checked: dict) -> dict:
    """The numbers compared for one timed fit (see the module note)."""
    steps = trajectory(prepared, checked)
    rms, gap = steps["rms"], steps["cost_gap"]
    if steps["last"] is not None:
        _, ref, ref_cost = steps["last"]
        rms = max(rms, centre_rms(output["clusterCenters"], ref))
        gap = max(gap, abs(float(output["trainingCost"]) / ref_cost - 1.0))
    cost = answer_cost(prepared, np.asarray(output["clusterCenters"]))
    differ = np.abs(np.asarray(output["clusterCenters"], np.float64)
                    - np.asarray(checked["clusterCenters"], np.float64)).max()
    differ = max(float(differ), abs(float(output["trainingCost"]) - float(checked["trainingCost"])))
    return {"centre_rms": rms, "cost_gap": gap,
            "excess_cost": cost / prepared["truth_cost"] - 1.0, "same": differ}


def control_output(config: dict, prepared: dict, output: dict) -> dict:
    """The control in the program's place: the fit's last step computed from
    the same input centres in f32 with both products in TF32."""
    prev = trajectory(prepared, output)["last"][0]
    new, cost = lloyd_step(prepared["x"], prev.to(torch.float32), torch.float32, tf32=True)
    return {**output, "clusterCenters": new.cpu().numpy(), "trainingCost": cost}
