"""The port's lint CLI.

Usage (from the repo root):

    python -m spark_rapids_ml_tpu_torch.analysis                # lint the port
    python -m spark_rapids_ml_tpu_torch.analysis --strict       # nonzero on findings
    python -m spark_rapids_ml_tpu_torch.analysis --list-rules   # rules, and those with no counterpart
    python -m spark_rapids_ml_tpu_torch.analysis --list-knobs [--markdown]
    python -m spark_rapids_ml_tpu_torch.analysis --check-readme # README port knob table drift gate

Default lint surface: the port's package and ``chip_smoke.py``. Exit code 0
means clean (suppressed findings do not count); with ``--strict``,
unparseable files also fail. There is no baseline: each finding is fixed,
or suppressed on its line with the reason.
"""

from __future__ import annotations

import argparse
import os
import sys

from spark_rapids_ml_tpu_torch.analysis.engine import lint_paths
from spark_rapids_ml_tpu_torch.analysis.rules import ALL_RULES, NO_COUNTERPART
from spark_rapids_ml_tpu_torch.utils import knobs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_PATHS = ("spark_rapids_ml_tpu_torch", "chip_smoke.py")

README_BEGIN = "<!-- tpulint-torch:knob-table:begin -->"
README_END = "<!-- tpulint-torch:knob-table:end -->"


def _list_rules() -> str:
    out = []
    for r in ALL_RULES:
        out.append(f"{r.id} ({r.name})")
        out.append(f"    {r.doc}")
    for rule_id, (name, reason) in NO_COUNTERPART.items():
        out.append(f"{rule_id} ({name}) has no counterpart in the port")
        out.append(f"    {reason}")
    return "\n".join(out)


def _list_knobs(markdown: bool) -> str:
    if markdown:
        return knobs.markdown_table()
    out = []
    for k in knobs.KNOBS.values():
        default = k.default if k.default else "<unset>"
        out.append(f"{k.name}  [{k.type}, default {default}]  ({k.module})")
        out.append(f"    {k.doc}")
    for name, reason in knobs.NOT_READ.items():
        out.append(f"{name}  not read by the port")
        out.append(f"    {reason}")
    return "\n".join(out)


def _check_readme(root: str) -> int:
    """0 iff the README's generated port knob table matches the inventory."""
    with open(os.path.join(root, "README.md"), encoding="utf-8") as f:
        readme = f.read()
    try:
        _, rest = readme.split(README_BEGIN, 1)
        table, _ = rest.split(README_END, 1)
    except ValueError:
        print(f"README.md: missing {README_BEGIN}/{README_END} markers", file=sys.stderr)
        return 1
    if table.strip() != knobs.markdown_table().strip():
        print(
            "README.md port knob table is stale — regenerate the block between "
            "the tpulint-torch:knob-table markers with:\n"
            "    python -m spark_rapids_ml_tpu_torch.analysis --list-knobs --markdown",
            file=sys.stderr,
        )
        return 1
    print("README.md port knob table matches utils.knobs declarations")
    return 0


def main(argv: list[str] | None = None, root: str = ROOT) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spark_rapids_ml_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*",
                    help=f"files/dirs to lint (default: {' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on live findings or unparseable files")
    ap.add_argument("--list-rules", action="store_true",
                    help="print rule IDs and docs, then exit")
    ap.add_argument("--list-knobs", action="store_true",
                    help="print the declared TPU_ML_* knob inventory")
    ap.add_argument("--markdown", action="store_true",
                    help="with --list-knobs: emit the README markdown table")
    ap.add_argument("--check-readme", action="store_true",
                    help="verify the README port knob table matches the inventory")
    args = ap.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0
    if args.list_knobs:
        print(_list_knobs(args.markdown))
        return 0
    if args.check_readme:
        return _check_readme(root)

    paths = args.paths or [os.path.join(root, p) for p in DEFAULT_PATHS]
    findings, errors = lint_paths(paths, ALL_RULES, root=root)
    live = [f for f in findings if not f.suppressed]
    for f in live:
        print(f.render())
    for e in errors:
        print(f"error: {e}", file=sys.stderr)
    counts = (f"{len(live)} live finding(s), "
              f"{sum(1 for f in findings if f.suppressed)} suppressed")
    print(counts if live or errors else f"clean — {counts}")
    if live:
        return 1
    if args.strict and errors:
        return 1
    return 0

if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # e.g. `--list-rules | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
