"""The port's static analysis (``spark_rapids_ml_tpu_torch/analysis``), its
knob inventory (``utils/knobs.py``) and name registry (``telemetry/names.py``).

Fixture sources are linted in memory: each port rule has a true positive and
a suppressed case; the rules carried over as they are (TPL004, TPL007,
TPL008) give the JAX package's rules' findings on the same sources; the
inventory's shared knobs carry JAX's type and default; and ``--strict``
over the port's own tree exits 0 with no baseline.
"""

import ast
import io
import json
import pathlib
import textwrap
import tokenize

import jax  # noqa: F401  (imported at the top of every port test file)
import pytest

from spark_rapids_ml_tpu.analysis import rules as jrules
from spark_rapids_ml_tpu.analysis.engine import lint_source as jlint
from spark_rapids_ml_tpu.utils import knobs as jknobs
from spark_rapids_ml_tpu_torch.analysis import __main__ as cli
from spark_rapids_ml_tpu_torch.analysis import rules
from spark_rapids_ml_tpu_torch.analysis.engine import (
    SUPPRESS_RE,
    Baseline,
    iter_py_files,
    lint_paths,
    lint_source,
)
from spark_rapids_ml_tpu_torch.telemetry import names
from spark_rapids_ml_tpu_torch.utils import knobs

REPO = pathlib.Path(__file__).resolve().parents[1]


def _lint(source: str, path: str, rule) -> list:
    return lint_source(textwrap.dedent(source), path, [rule])


def _live(findings) -> list[tuple[str, int]]:
    return [(f.rule, f.line) for f in findings if not f.suppressed]


# (rule, path, source with a true positive on line 3; "@@" marks where its
# suppression goes)
CASES = {
    "TPL002": (rules.HostSyncRule(), "pkg/ops/fold.py", """\
        import torch
        def step(x):
            return x.sum().item()@@
        """),
    "TPL004": (rules.RetryDisciplineRule(), "pkg/serving/poll.py", """\
        import time
        def poll(fn, backoff):
            time.sleep(backoff)@@
        """),
    "TPL005": (rules.NameRegistryRule(), "pkg/serving/x.py", """\
        from pkg.telemetry.registry import REGISTRY
        def f():
            REGISTRY.counter_inc("serve.requestz")@@
        """),
    "TPL006": (rules.KnobInventoryRule(), "pkg/utils/x.py", """\
        import os
        def f():
            return os.environ.get("TPU_ML_NOT_A_KNOB")@@
        """),
    "TPL007": (rules.TelemetryRaceRule(), "pkg/telemetry/x.py", """\
        _SEEN = {}
        def f(k):
            _SEEN[k] = 1@@
        """),
    "TPL008": (rules.SwallowedExceptionRule(), "pkg/ops/x.py", """\
        def f(g):
            try: g()
            except Exception: pass@@
        """),
}


@pytest.mark.parametrize("rule_id", sorted(CASES))
def test_each_rule_fires_and_is_suppressed_with_a_reason(rule_id):
    rule, path, source = CASES[rule_id]
    assert rule.id == rule_id
    assert _live(_lint(source.replace("@@", ""), path, rule)) == [(rule_id, 3)]
    suppressed = _lint(source.replace("@@", f"  # tpulint: disable={rule_id} -- on purpose"), path, rule)
    # TPL008 takes any same-line comment as the swallow's reason: no finding
    expected = [] if rule_id == "TPL008" else [(rule_id, True)]
    assert [(f.rule, f.suppressed) for f in suppressed] == expected
    # a suppression must say why: without a reason it is a finding itself
    bare = _lint(source.replace("@@", f"  # tpulint: disable={rule_id}"), path, rule)
    assert _live(bare) == [("TPL000", 3)]


@pytest.mark.parametrize("line", [
    "x.item()", "x.tolist()", "x.cpu()", "x.detach().numpy()", "torch.cuda.synchronize()",
    "float(torch.max(x))", "int(x.sum())", "bool(torch.isfinite(x).all())",
    "float(linalg.norm(x))", "t.tolist()", "int(t[1:].sum())", "bool((t != x).any())",
    "u.item()", "torch.stack([x, t]).tolist()",
])
def test_host_sync_flags(line):
    # x is annotated a tensor, t is bound from a torch call, u is unknown
    source = (f"import torch\nfrom torch import linalg\ndef f(x: torch.Tensor, u):\n"
              f"    t = torch.zeros(3)\n    return {line}\n")
    found = lint_source(source, "pkg/serving/hot.py", [rules.HostSyncRule()])
    assert [f.rule for f in found] and all(f.rule == "TPL002" for f in found)


@pytest.mark.parametrize("line", [
    "a.max()", "int(a.max())", "int(a[1:].sum())", "a.tolist()", "a.item()",
    "np.asarray(u).tolist()", "u.tolist()", "u.numpy()", "int(u.sum())",
    "float(b.min())", "w.tolist()",
])
def test_host_sync_leaves_numpy_and_unknown_values_alone(line):
    # a and b are NumPy arrays, u is unknown, w was a tensor and is now a
    # NumPy array
    source = (f"import numpy as np\nimport torch\ndef f(u, x: torch.Tensor):\n"
              f"    a = np.zeros(3)\n    b = a * 2\n    w = x\n    w = w.detach().numpy()\n"
              f"    return {line}\n")
    found = lint_source(source, "pkg/ops/hot.py", [rules.HostSyncRule()])
    assert [f for f in found if f.line == 8] == []


@pytest.mark.parametrize("line,path", [
    ("int(x.shape[0])", "pkg/ops/a.py"),
    ("int(x.size(0))", "pkg/ops/a.py"),
    ("float(x.numel())", "pkg/ops/a.py"),
    ("float(np.max(a))", "pkg/ops/a.py"),
    ("int(len(a))", "pkg/ops/a.py"),
    ("x.item()", "pkg/telemetry/a.py"),
    ("x.item()", "pkg/models/a.py"),
    ("float(shift)", "pkg/parallel/a.py"),
])
def test_host_sync_exemptions(line, path):
    source = f"import numpy as np\ndef f(x, a, shift):\n    return {line}\n"
    assert lint_source(source, path, [rules.HostSyncRule()]) == []


CARRIED = {
    "TPL004": ("pkg/parallel/x.py", """\
        import time
        def a(fn):
            for _ in range(3):
                try:
                    return fn()
                except OSError:
                    time.sleep(0.1)
        def b(delay):
            time.sleep(delay)
        def c():
            time.sleep(1.0)
        """),
    "TPL007": ("pkg/resilience/x.py", """\
        import threading
        _LOCK = threading.Lock()
        _HITS = []
        _BY = {}
        def a(v):
            _HITS.append(v)
            with _LOCK:
                _BY[v] = 1
        def b():
            global _HITS
            _HITS = []
        """),
    "TPL008": ("pkg/serving/x.py", """\
        def a(g):
            try:
                g()
            except Exception:
                pass
            try:
                g()
            except (ValueError, BaseException):
                pass
            try:
                g()
            except Exception:  # best effort: the caller retries
                pass
            try:
                g()
            except:
                pass
            try:
                g()
            except ValueError:
                pass
        """),
}


@pytest.mark.parametrize("rule_id", sorted(CARRIED))
def test_carried_rules_give_jax_findings(rule_id):
    path, source = CARRIED[rule_id]
    source = textwrap.dedent(source)
    port_rule = next(r for r in rules.ALL_RULES if r.id == rule_id)
    jax_rule = next(r for r in jrules.ALL_RULES if r.id == rule_id)
    ours = [f.to_dict() for f in lint_source(source, path, [port_rule])]
    theirs = [f.to_dict() for f in jlint(source, path, [jax_rule])]
    assert ours and ours == theirs


def test_registry_rules_read_the_ports_registries():
    source = textwrap.dedent("""\
        from x import REGISTRY, TIMELINE, faults, trace_range
        def f():
            REGISTRY.counter_inc("compile.graph_captures")
            REGISTRY.gauge_set(f"device.{1}", 0)
            TIMELINE.record_instant("serve.swap")
            faults.inject("serve.dispatch")
            with trace_range("ann lloyd"):
                pass
            REGISTRY.counter_inc("compile.count")
            REGISTRY.histogram_record(f"xla.{1}", 0)
            faults.inject("serve.nowhere")
            return "TPU_ML_DEFAULT_PRECISION", "TPU_ML_COMPILE_CACHE"
        """)
    found = lint_source(source, "pkg/serving/x.py",
                        [rules.NameRegistryRule(), rules.KnobInventoryRule()])
    # the port's own names pass; XLA's compile events, an unknown prefix, an
    # unknown site and a knob the port does not read are flagged
    assert [(f.rule, f.line) for f in found] == [
        ("TPL005", 9), ("TPL005", 10), ("TPL005", 11), ("TPL006", 12),
    ]


def test_shared_knobs_carry_jax_type_and_default():
    shared = set(knobs.KNOBS) & set(jknobs.KNOBS)
    assert shared == set(knobs.KNOBS)  # the port reads no knob of its own
    for name in shared:
        ours, theirs = knobs.KNOBS[name], jknobs.KNOBS[name]
        assert ours.type == theirs.type, name
        if name not in knobs.DEFAULTS_DIFFER:
            assert ours.default == theirs.default, name
    assert knobs.PEAK_TFLOPS.value == 989.4
    # every JAX knob is read here or listed with its reason, never both
    assert set(knobs.NOT_READ) == set(jknobs.KNOBS) - set(knobs.KNOBS)
    assert all(reason for reason in knobs.NOT_READ.values())


def test_knob_values_parse_by_type():
    assert knobs.STREAM_FIT_MAX_RESIDENT_BYTES.value == 1 << 31
    assert knobs.SERVE_MAX_DELAY_US.value == 2000.0
    assert knobs.HTTP_PORT.value is None  # unset
    assert knobs.ADMISSION_POLICY.value == "refuse"


def _booked(method: str) -> set[str]:
    out = set()
    for path in (REPO / "spark_rapids_ml_tpu_torch").rglob("*.py"):
        for n in ast.walk(ast.parse(path.read_text())):
            if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                    and n.func.attr == method and n.args
                    and isinstance(n.args[0], ast.Constant)):
                out.add(n.args[0].value)
    return out


def test_every_booked_family_has_its_declared_kind():
    histograms, gauges, counters = (_booked(m) for m in
                                    ("histogram_record", "gauge_set", "counter_inc"))
    assert histograms <= names.HISTOGRAMS
    assert gauges <= names.GAUGES
    assert not counters & (names.HISTOGRAMS | names.GAUGES)
    assert (histograms | gauges | counters) <= names.METRICS
    assert names.HISTOGRAMS <= names.METRICS and names.GAUGES <= names.METRICS


def test_strict_over_the_port_is_clean_without_a_baseline(capsys):
    assert cli.main(["--strict"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("clean — 0 live finding(s)")


def test_every_suppression_in_the_port_silences_a_finding_of_its_rule():
    """No stale suppression: each ``# tpulint: disable=`` comment stands on
    (or just above) a line where its rules fire."""
    paths = [str(REPO / "spark_rapids_ml_tpu_torch"), str(REPO / "chip_smoke.py")]
    findings, errors = lint_paths(paths, rules.ALL_RULES, root=str(REPO))
    assert errors == []
    silenced = {(f.path, f.line, f.rule) for f in findings if f.suppressed}
    unused = []
    for path in iter_py_files(paths):
        relpath = pathlib.Path(path).relative_to(REPO).as_posix()
        source = pathlib.Path(path).read_text()
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            m = SUPPRESS_RE.search(tok.string) if tok.type == tokenize.COMMENT else None
            if m:
                line = tok.start[0] + (1 if tok.line.lstrip().startswith("#") else 0)
                unused += [(relpath, line, r.strip()) for r in m.group(1).split(",")
                           if (relpath, line, r.strip()) not in silenced]
    assert unused == []


def test_list_rules_names_the_rules_without_a_counterpart(capsys):
    assert cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in rules.ALL_RULES:
        assert f"{rule.id} ({rule.name})" in out
    assert "TPL001 (donated-carry) has no counterpart" in out
    assert "TPL003 (recompile-hazard) has no counterpart" in out


def test_list_knobs_and_the_readme_table(capsys):
    assert cli.main(["--list-knobs"]) == 0
    out = capsys.readouterr().out
    assert "TPU_ML_COMPILE_CACHE  not read by the port" in out
    assert "TPU_ML_DEFAULT_PRECISION  [enum, default highest]" in out
    assert cli.main(["--list-knobs", "--markdown"]) == 0
    assert capsys.readouterr().out.strip() == knobs.markdown_table()
    assert cli.main(["--check-readme"]) == 0


def test_check_readme_catches_a_stale_table(tmp_path, capsys):
    (tmp_path / "README.md").write_text(
        f"{cli.README_BEGIN}\n| stale |\n{cli.README_END}\n")
    assert cli.main(["--check-readme"], root=str(tmp_path)) == 1
    (tmp_path / "README.md").write_text("no markers\n")
    assert cli.main(["--check-readme"], root=str(tmp_path)) == 1


def test_a_baseline_blesses_a_finding_by_its_fingerprint(tmp_path, capsys):
    found = lint_source("def f(x):\n    return x.item()\n", "pkg/ops/hot.py", [rules.HostSyncRule()])
    entry = dict(found[0].to_dict(), note="fixture")
    assert entry["rule"] == "TPL002" and entry["line"] == 2 and entry["scope"] == "f"
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"entries": [entry]}))
    # the fingerprint has no line number: the finding moved two lines down
    moved = lint_source("\n\ndef f(x):\n    return x.item()\n", "pkg/ops/hot.py",
                        [rules.HostSyncRule()])
    Baseline.load(str(path)).apply(moved)
    assert moved[0].baselined and moved[0].note == "fixture"
    assert moved[0].render().endswith("[baselined]")
    assert Baseline.load(str(tmp_path / "absent.json")).entries == {}
