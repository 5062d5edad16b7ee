"""The readings that a cell's limits are set from: the numbers compared for
checked fits of the program, for the control and for planted faults, each
seed's inputs made once and read by all, in one process.

    python3 -m h100bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults name,name --fault-seeds 1,2,3]

The control is the reference module's ``control_output`` put in the
program's place on the sound fit's own state; a fault is one of
``faults.py``, planted in the program. Each side is judged as a run judges
its timed fits: against its own checked fit. Prints one JSON line a fit
and a summary: for each number the largest sound reading, the smallest
control reading, the smallest reading of each fault, and the limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench import hygiene, spec  # noqa: E402


def readings(cell: spec.Cell, seeds, control_seeds=(), faults=(), fault_seeds=(),
             device=None) -> list[dict]:
    """One entry a fit: {seed, side ("sound", "control" or the fault's
    name), numbers}."""
    import torch

    from h100bench import faults as planted
    from h100bench.reference import data
    from h100bench.system import System

    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    config = cell.config
    ref = spec.reference(config["reference"], cell.bench_dir)
    out = []
    for seed in dict.fromkeys(list(seeds) + list(control_seeds) + list(fault_seeds)):
        scratch = tempfile.mkdtemp(prefix="h100bench-cal-")
        try:
            x = data.make(config["data"], seed, device)
            fits = {}
            for name in ([None] + list(faults)) if seed in fault_seeds else [None]:
                patch = planted.Patch()
                if name is not None:
                    planted.FAULTS[name](patch)
                try:
                    op = System(config, seed, device, x, scratch).operation(
                        cell.traffic["op"], cell.traffic)
                    fits[name or "sound"] = op(0, check=True)
                finally:
                    patch.undo()
            prepared = ref.prepare(config, x, device, seed)
            sides = dict(fits)
            if seed not in seeds:
                del sides["sound"]
            if seed in control_seeds:
                sides["control"] = ref.control_output(config, prepared, fits["sound"])
            for side, output in sides.items():
                # each side is judged as a run of it would be: against itself
                # as the checked fit (the control's steps before its last are
                # the sound fit's)
                entry = {"seed": seed, "side": side,
                         "numbers": ref.judge(config, prepared, output, output)}
                print(json.dumps(entry), flush=True)
                out.append(entry)
            del x, prepared
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
    return out


def summarize(config: dict, entries: list[dict]) -> dict:
    out = {}
    for name, limit in config["limits"].items():
        row = {"limit": limit}
        for side in dict.fromkeys(e["side"] for e in entries):
            values = [e["numbers"][name] for e in entries if e["side"] == side]
            row[f"{side}_{'max' if side == 'sound' else 'min'}"] = (
                max(values) if side == "sound" else min(values))
        out[name] = row
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args(argv)
    checkout = Path(__file__).resolve().parents[1]
    cell = spec.load_cell(args.workload, checkout)
    hygiene.prepare_environment(cell.config, checkout)
    import torch

    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2

    def ints(text):
        return [int(s) for s in text.split(",") if s]

    entries = readings(cell, ints(args.seeds), ints(args.control_seeds),
                       [f for f in args.faults.split(",") if f], ints(args.fault_seeds),
                       torch.device("cuda", 0))
    print(json.dumps({"summary": summarize(cell.config, entries)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
