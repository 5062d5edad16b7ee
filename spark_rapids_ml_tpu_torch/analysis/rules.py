"""The port's lint rules: its invariants, as code.

The rules of the JAX package's ``analysis/rules.py`` that hold for PyTorch
code, and one rewritten for it. Each rule subclasses
:class:`~.engine.Rule` and documents what it enforces and why. Rules are
heuristic on purpose: they resolve only module-local facts (imports,
same-file defs) and skip what they cannot resolve; a linter that guesses
produces noise, and noise gets disabled. A site a rule flags wrongly, or
one that breaks the rule on purpose, is silenced with ``# tpulint:
disable=RULE <reason>`` on its line.

- TPL002 is the port's own: a host sync in a hot path is ``.item()``,
  ``.cpu()``, ``torch.cuda.synchronize()``, or ``.tolist()``/``.numpy()``
  of a tensor or ``float()``/``int()``/``bool()`` of a call on a tensor, in
  ``ops/``, ``parallel/`` and ``serving/``; :class:`ValueKinds` tells a
  tensor from a NumPy value by module-local facts.
- TPL004, TPL007 and TPL008 are the JAX package's rules as they are.
- TPL005 and TPL006 are the JAX package's rules over the port's own
  registries (``telemetry/names.py``, ``resilience/sites.py``,
  ``utils/knobs.py``).
- TPL001 (donated carry) and TPL003 (recompile hazard) are rules about
  ``jax.jit`` and have no counterpart (``NO_COUNTERPART``).
"""

from __future__ import annotations

import ast
from typing import Iterator

from spark_rapids_ml_tpu_torch.analysis.engine import (
    Finding,
    LintedModule,
    Rule,
    dotted_name,
)

_SHAPE_ATTRS = frozenset({"shape", "ndim", "dtype", "device"})
_SHAPE_METHODS = frozenset({"size", "dim", "numel", "nelement", "element_size"})
# methods whose result is a host value, whatever their receiver
_HOST_RESULT_METHODS = frozenset({"item", "tolist", "numpy"})
# tensor methods whose result is no tensor
_NON_TENSOR_METHODS = _SHAPE_METHODS | frozenset({
    "data_ptr", "stride", "storage_offset", "is_contiguous", "get_device",
    "is_floating_point", "is_complex",
})
# tensor attributes that are tensors themselves
_TENSOR_ATTRS = frozenset({"T", "mT", "H", "mH", "real", "imag", "data", "grad"})
# torch.* callables whose result is no tensor
_TORCH_NON_TENSOR = (
    "torch.cuda.", "torch.backends.", "torch.distributed.", "torch.is_",
    "torch.get_", "torch.device", "torch.dtype", "torch.finfo", "torch.iinfo",
    "torch.Size", "torch.Generator", "torch.no_grad", "torch.inference_mode",
)

TENSOR, HOST = "tensor", "host"


class ValueKinds:
    """Whether an expression is a torch tensor or a host (NumPy) value,
    from module-local facts only: a ``torch.*`` or ``numpy.*`` call, a
    parameter or variable annotated ``torch.Tensor``, a name whose latest
    binding above the use is one of those, and the indexing, arithmetic
    and method calls on such a value. Anything else is unknown (None)."""

    def __init__(self, mod: LintedModule):
        self.mod = mod
        # scope (def node, or None for the module) -> name -> [(line, value)];
        # a value is an expression, TENSOR (an annotation) or None (unknown)
        self.binds: dict[ast.AST | None, dict[str, list]] = {}
        for n in ast.walk(mod.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = n.args
                for arg in a.posonlyargs + a.args + a.kwonlyargs:
                    value = TENSOR if self._is_tensor_type(arg.annotation) else None
                    self._bind(n, arg.arg, n.lineno, value)
            elif isinstance(n, ast.Assign):
                value = n.value if len(n.targets) == 1 else None
                for t in n.targets:
                    self._bind_target(n, t, value)
            elif isinstance(n, ast.AnnAssign):
                value = TENSOR if self._is_tensor_type(n.annotation) else n.value
                self._bind_target(n, n.target, value)
            elif isinstance(n, (ast.For, ast.AsyncFor)):
                self._bind_target(n, n.target, None)
            elif isinstance(n, ast.withitem) and n.optional_vars is not None:
                self._bind_target(n.context_expr, n.optional_vars, None)
        for names in self.binds.values():
            for entries in names.values():
                entries.sort(key=lambda e: e[0])

    def _is_tensor_type(self, ann: ast.AST | None) -> bool:
        if ann is None:
            return False
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.split("|")[0].strip() in ("torch.Tensor", "Tensor")
        return any(
            isinstance(x, (ast.Name, ast.Attribute))
            and self.mod.resolves_to(x, "torch.Tensor")
            for x in ast.walk(ann)
        )

    def _bind(self, scope, name: str, line: int, value) -> None:
        self.binds.setdefault(scope, {}).setdefault(name, []).append((line, value))

    def _bind_target(self, node: ast.AST, target: ast.AST, value) -> None:
        scope = self.mod.enclosing_function(node)
        if isinstance(target, ast.Name):
            self._bind(scope, target.id, node.lineno, value)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for t in target.elts:
                self._bind_target(node, t, None)

    def _origin(self, func: ast.AST) -> str:
        got = dotted_name(func)
        head, _, rest = got.partition(".")
        origin = self.mod.imports.get(head, head if head in ("torch", "numpy") else "")
        return origin + ("." + rest if rest and origin else "")

    def of(self, e: ast.AST, depth: int = 0) -> str | None:
        if depth > 32:
            return None
        if isinstance(e, ast.Call):
            origin = self._origin(e.func)
            if origin.startswith("numpy."):
                return HOST
            if origin.startswith("torch."):
                return None if origin.startswith(_TORCH_NON_TENSOR) else TENSOR
            if not isinstance(e.func, ast.Attribute):
                return None
            recv = self.of(e.func.value, depth + 1)
            if recv is None:
                return None
            if e.func.attr in _HOST_RESULT_METHODS:
                return HOST
            if recv == TENSOR and e.func.attr in _NON_TENSOR_METHODS:
                return None
            return recv
        if isinstance(e, ast.Name):
            return self._name(e, depth)
        if isinstance(e, ast.Attribute):
            recv = self.of(e.value, depth + 1)
            if recv == TENSOR and e.attr in _TENSOR_ATTRS:
                return TENSOR
            return HOST if recv == HOST and e.attr in ("T", "real", "imag") else None
        if isinstance(e, ast.Subscript):
            return self.of(e.value, depth + 1)
        if isinstance(e, ast.UnaryOp):
            return self.of(e.operand, depth + 1)
        if isinstance(e, (ast.BinOp, ast.Compare)):
            parts = [e.left, e.right] if isinstance(e, ast.BinOp) else [e.left, *e.comparators]
            kinds = {self.of(p, depth + 1) for p in parts}
            return TENSOR if TENSOR in kinds else HOST if HOST in kinds else None
        return None

    def _name(self, node: ast.Name, depth: int) -> str | None:
        scope = self.mod.enclosing_function(node)
        while True:
            entries = self.binds.get(scope, {}).get(node.id)
            if entries:
                before = [v for line, v in entries if line < node.lineno]
                if not before:
                    return None
                value = before[-1]
                if value is None or value == TENSOR:
                    return value
                return self.of(value, depth + 1)
            if scope is None:
                return None
            scope = self.mod.enclosing_function(scope)


# The JAX package's rules that have no counterpart here, and why.
NO_COUNTERPART: dict[str, tuple[str, str]] = {
    "TPL001": (
        "donated-carry",
        "a rule about jax.jit's donate_argnums: PyTorch runs no compiled "
        "program whose input buffer could be donated; a fold's carry is a "
        "tensor its step updates or replaces, and the caching allocator "
        "reuses the freed blocks",
    ),
    "TPL003": (
        "recompile-hazard",
        "a rule about building jax.jit programs per call: the port compiles "
        "no programs at run time; its CUDA kernels build once per source "
        "(ops/_build.py) and its serve path captures one CUDA graph per "
        "rung at register()",
    ),
}


class HostSyncRule(Rule):
    id = "TPL002"
    name = "host-sync-in-hot-path"
    doc = (
        "No .item()/.cpu()/torch.cuda.synchronize(), and no .tolist()/"
        ".numpy() of a tensor or float()/int()/bool() of a call on a tensor "
        "(a torch.* call, or a method of a tensor such as .sum()/.all()), in "
        "ops/, parallel/ and serving/: each waits for the card and copies "
        "to the host, so in the device compute layer and on the warm serve "
        "path it is a stall per call. A tensor is what module-local facts "
        "show (a torch.* call, a torch.Tensor annotation, a name bound to "
        "one); NumPy values and values the rule cannot place are left "
        "alone, and so is .item() of a NumPy value. Shape, dtype and size "
        "reads are exempt (they never touch the card), and so is "
        "telemetry/ (measurement may sync). A loop that reads the host on "
        "purpose (a convergence test, a checkpoint) says so with a "
        "same-line suppression and its reason."
    )

    SYNC_CALLS = ("torch.cuda.synchronize",)
    SYNC_BUILTINS = frozenset({"float", "int", "bool"})
    SCOPES = {
        "/ops/": "ops/ device compute module",
        "/parallel/": "parallel/ mesh program module",
        "/serving/": "serving/ warm-path module",
    }

    def check(self, mod: LintedModule) -> Iterator[Finding]:
        if "/telemetry/" in mod.relpath:
            return
        ctx = next((c for s, c in self.SCOPES.items() if s in mod.relpath), None)
        if ctx is None:
            return
        kinds = ValueKinds(mod)
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            func = n.func
            if isinstance(func, ast.Attribute) and func.attr in ("item", "cpu", "tolist", "numpy"):
                recv = kinds.of(func.value)
                # .item() and .cpu() are the tensor's own idiom; .tolist() and
                # .numpy() are NumPy's too, so they need a known tensor
                if recv == TENSOR or (func.attr in ("item", "cpu") and recv is None):
                    yield self.finding(
                        mod, n, f".{func.attr}() forces a device->host sync ({ctx})"
                    )
            elif any(mod.call_is(n, c) for c in self.SYNC_CALLS):
                yield self.finding(
                    mod, n, f"{dotted_name(func)}() waits for the card ({ctx})"
                )
            elif (
                isinstance(func, ast.Name)
                and func.id in self.SYNC_BUILTINS
                and len(n.args) == 1
                and isinstance(n.args[0], ast.Call)
                and not self._reads_shape(n.args[0])
                and kinds.of(n.args[0]) == TENSOR
            ):
                yield self.finding(
                    mod, n,
                    f"{func.id}() of a tensor result copies it to the host "
                    f"({ctx})",
                )

    @staticmethod
    def _reads_shape(arg: ast.expr) -> bool:
        """A shape, dtype or size read anywhere inside ``arg``."""
        for n in ast.walk(arg):
            if isinstance(n, ast.Attribute) and n.attr in _SHAPE_ATTRS:
                return True
            if isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Attribute) and n.func.attr in _SHAPE_METHODS)
                or (isinstance(n.func, ast.Name) and n.func.id == "len")
            ):
                return True
        return False


class RetryDisciplineRule(Rule):
    id = "TPL004"
    name = "retry-discipline"
    doc = (
        "No hand-rolled time.sleep retry loops outside resilience/retry.py "
        "— the shared call_with_retry is the one backoff loop: it "
        "classifies errors, respects the attempt/deadline knobs, counts "
        "retry.attempts in telemetry, and never sleeps after the final "
        "attempt (a bug the executor once had). A sleep inside an "
        "except handler, inside a loop that catches exceptions, or fed "
        "from a backoff variable is hand-rolled retry machinery."
    )

    BACKOFF_NAMES = ("backoff", "retry", "delay")

    def check(self, mod: LintedModule) -> Iterator[Finding]:
        if mod.relpath.endswith("resilience/retry.py"):
            return
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Call) and mod.call_is(n, "time.sleep")):
                continue
            ancestors = list(mod.ancestors(n))
            in_except = any(isinstance(a, ast.ExceptHandler) for a in ancestors)
            loop = next(
                (a for a in ancestors if isinstance(a, (ast.For, ast.While))),
                None,
            )
            loop_catches = loop is not None and any(
                isinstance(x, ast.Try) for x in ast.walk(loop)
            )
            backoff_arg = bool(n.args) and any(
                isinstance(x, ast.Name)
                and any(b in x.id.lower() for b in self.BACKOFF_NAMES)
                for x in ast.walk(n.args[0])
            )
            if in_except or loop_catches or backoff_arg:
                yield self.finding(
                    mod, n,
                    "hand-rolled sleep-based retry — route this through "
                    "resilience.retry.call_with_retry (shared policy, "
                    "telemetry counters, no sleep-after-final-attempt)",
                )


class NameRegistryRule(Rule):
    id = "TPL005"
    name = "name-registry"
    doc = (
        "Metric, span, timeline-instant and fault-site string literals at "
        "call sites must resolve against the canonical registries "
        "(telemetry/names.py, resilience/sites.py). A typo'd name does "
        "not error — it mints a silent new metric family no dashboard or "
        "anomaly check reads, or a fault gate no chaos plan can hit. "
        "Adding a series means declaring it in the registry first."
    )

    METRIC_FNS = frozenset({"counter_inc", "gauge_set", "histogram_record"})

    def __init__(self, metrics=None, prefixes=None, spans=None,
                 instants=None, sites=None):
        if metrics is None:
            from spark_rapids_ml_tpu_torch.resilience.sites import FAULT_SITES
            from spark_rapids_ml_tpu_torch.telemetry.names import (
                INSTANTS, METRIC_PREFIXES, METRICS, SPAN_PHASES,
            )
            metrics, prefixes = METRICS, METRIC_PREFIXES
            spans, instants, sites = SPAN_PHASES, INSTANTS, FAULT_SITES
        self.metrics = metrics
        self.prefixes = tuple(prefixes or ())
        self.spans = spans or frozenset()
        self.instants = instants or frozenset()
        self.sites = sites or frozenset()

    def check(self, mod: LintedModule) -> Iterator[Finding]:
        if mod.relpath.endswith(("telemetry/names.py", "resilience/sites.py")):
            return
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Call) and n.args):
                continue
            func = n.func
            attr = (
                func.attr if isinstance(func, ast.Attribute)
                else func.id if isinstance(func, ast.Name) else ""
            )
            lit = self._literal(n.args[0])
            if attr in self.METRIC_FNS:
                kind, registry = "metric", self.metrics
            elif attr == "trace_range" or attr == "record_span":
                kind, registry = "span phase", self.spans
            elif attr == "record_instant":
                kind, registry = "timeline instant", self.instants
            elif attr == "inject" and self._is_fault_inject(mod, func):
                kind, registry = "fault site", self.sites
            else:
                continue
            if lit is None:
                # f-string with a literal head: prefix-check metrics
                if kind == "metric":
                    head = self._fstring_head(n.args[0])
                    if head is not None and not any(
                        head.startswith(p) for p in self.prefixes
                    ):
                        yield self.finding(
                            mod, n,
                            f"dynamic metric name with unregistered prefix "
                            f"{head!r} — declare the prefix in "
                            "telemetry.names.METRIC_PREFIXES",
                        )
                continue
            ok = lit in registry or (
                kind == "metric"
                and any(lit.startswith(p) for p in self.prefixes)
            )
            if not ok:
                where = (
                    "telemetry.names" if kind != "fault site"
                    else "resilience.sites"
                )
                yield self.finding(
                    mod, n,
                    f"{kind} {lit!r} is not declared in the {where} "
                    "registry — a typo here silently mints a new family; "
                    "declare it (or fix the name)",
                )

    @staticmethod
    def _literal(node: ast.expr) -> str | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return None

    @staticmethod
    def _fstring_head(node: ast.expr) -> str | None:
        if isinstance(node, ast.JoinedStr) and node.values:
            first = node.values[0]
            if isinstance(first, ast.Constant) and isinstance(first.value, str):
                return first.value
        return None

    @staticmethod
    def _is_fault_inject(mod: LintedModule, func: ast.expr) -> bool:
        name = dotted_name(func)
        if name.endswith("faults.inject"):
            return True
        origin = mod.imports.get(name, "")
        return name == "inject" and origin.endswith("faults.inject")


class KnobInventoryRule(Rule):
    id = "TPL006"
    name = "knob-inventory"
    doc = (
        "Every TPU_ML_* environment knob must be declared in "
        "utils/knobs.py (name, type, default, doc, consumer) — the "
        "declaration is what --list-knobs renders and what keeps the "
        "README knob table honest (CI drift-checks them against each "
        "other). Any TPU_ML_* string literal outside the declaration "
        "module is either an undeclared knob or a typo'd read of a "
        "declared one; both ship silent misconfiguration."
    )

    def __init__(self, declared=None):
        if declared is None:
            from spark_rapids_ml_tpu_torch.utils.knobs import KNOBS
            declared = frozenset(KNOBS)
        self.declared = declared

    def check(self, mod: LintedModule) -> Iterator[Finding]:
        if mod.relpath.endswith("utils/knobs.py"):
            return
        for n in ast.walk(mod.tree):
            if not (isinstance(n, ast.Constant) and isinstance(n.value, str)):
                continue
            v = n.value
            if not (v.startswith("TPU_ML_") and len(v) > len("TPU_ML_")
                    and v.replace("_", "").isalnum() and v == v.upper()):
                continue
            parent = mod.parents.get(n)
            if isinstance(parent, ast.Expr):
                continue  # docstring / bare string statement
            if v not in self.declared:
                yield self.finding(
                    mod, n,
                    f"env knob {v!r} is not declared in utils.knobs.KNOBS "
                    "— declare it there (and prefer referencing "
                    "knobs.<NAME>.name over a fresh literal)",
                )


class TelemetryRaceRule(Rule):
    id = "TPL007"
    name = "telemetry-race"
    doc = (
        "Module-level mutable state in telemetry/ and resilience/ must "
        "only be mutated under a lock: these modules are written to from "
        "the partition executor's thread pool and from worker callbacks, "
        "and unlocked dict/list mutation corrupts counts exactly the way "
        "the registry lock exists to prevent. A mutation (or a "
        "`global` rebind) with no enclosing `with <lock>:` is a finding."
    )

    SCOPES = ("/telemetry/", "/resilience/")
    MUTATORS = frozenset({
        "append", "add", "update", "clear", "pop", "popitem",
        "setdefault", "extend", "remove", "discard", "insert",
    })
    MUTABLE_CTORS = frozenset({
        "dict", "list", "set", "defaultdict", "deque", "OrderedDict",
        "Counter",
    })

    def check(self, mod: LintedModule) -> Iterator[Finding]:
        if not any(s in mod.relpath for s in self.SCOPES):
            return
        mutable = self._module_mutables(mod)
        if not mutable:
            return
        for n in ast.walk(mod.tree):
            name = self._mutation_target(n, mutable, mod)
            if name and not self._under_lock(mod, n):
                yield self.finding(
                    mod, n,
                    f"module-level mutable {name!r} mutated outside a "
                    "lock — wrap in `with <lock>:` (or prove the path "
                    "single-threaded and bless with a note)",
                )

    def _module_mutables(self, mod: LintedModule) -> set[str]:
        out: set[str] = set()
        for stmt in mod.tree.body:
            targets: list[ast.expr] = []
            value: ast.expr | None = None
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            if value is None:
                continue
            is_mutable = isinstance(
                value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                        ast.ListComp, ast.SetComp)
            ) or (
                isinstance(value, ast.Call)
                and dotted_name(value.func).split(".")[-1] in self.MUTABLE_CTORS
            )
            if is_mutable:
                out.update(
                    t.id for t in targets if isinstance(t, ast.Name)
                )
        return out

    def _mutation_target(self, n: ast.AST, mutable: set[str], mod) -> str | None:
        # x[k] = v / del x[k] / x[k] += v
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (
                n.targets if isinstance(n, ast.Assign)
                else [n.target] if isinstance(n, ast.AugAssign)
                else n.targets
            )
            for t in targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in mutable
                ):
                    return t.value.id
            # global rebind: `global x` + assignment inside a function
            if isinstance(n, ast.Assign):
                fn = mod.enclosing_function(n)
                if fn is not None:
                    declared_global = {
                        g for s in ast.walk(fn)
                        if isinstance(s, ast.Global) for g in s.names
                    }
                    for t in targets:
                        if isinstance(t, ast.Name) and t.id in mutable \
                                and t.id in declared_global:
                            return t.id
        # x.append(...) etc.
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in self.MUTATORS
            and isinstance(n.func.value, ast.Name)
            and n.func.value.id in mutable
        ):
            return n.func.value.id
        return None

    @staticmethod
    def _under_lock(mod: LintedModule, n: ast.AST) -> bool:
        for a in mod.ancestors(n):
            if isinstance(a, ast.With):
                for item in a.items:
                    if "lock" in ast.unparse(item.context_expr).lower():
                        return True
        return False


class SwallowedExceptionRule(Rule):
    id = "TPL008"
    name = "swallowed-exception"
    doc = (
        "`except Exception: pass` (or a bare except: pass) with no "
        "explanation swallows every failure mode including the CUDA "
        "runtime errors the retry classifier must see; exactly this "
        "pattern once hid a retry bug. A broad "
        "swallow is allowed only with a same-line comment saying why "
        "(narrow handlers, or handlers that do something, are fine)."
    )

    BROAD = frozenset({"Exception", "BaseException"})

    def check(self, mod: LintedModule) -> Iterator[Finding]:
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.ExceptHandler):
                continue
            if not (len(n.body) == 1 and isinstance(n.body[0], ast.Pass)):
                continue
            if not self._is_broad(n.type):
                continue
            # intent may be documented on the except line or the pass line
            last = min(n.body[0].lineno, len(mod.lines))
            if any("#" in mod.lines[i - 1] for i in range(n.lineno, last + 1)):
                continue
            what = "bare except" if n.type is None else dotted_name(n.type)
            yield self.finding(
                mod, n,
                f"{what}: pass silently swallows every failure — narrow "
                "the type, handle it, or add a same-line comment saying "
                "why ignoring is correct",
            )

    def _is_broad(self, t: ast.expr | None) -> bool:
        if t is None:
            return True
        if isinstance(t, ast.Tuple):
            return any(self._is_broad(e) for e in t.elts)
        return dotted_name(t).split(".")[-1] in self.BROAD


def all_rules() -> list[Rule]:
    """Fresh instances of every rule, registry-backed defaults."""
    return [
        HostSyncRule(),
        RetryDisciplineRule(),
        NameRegistryRule(),
        KnobInventoryRule(),
        TelemetryRaceRule(),
        SwallowedExceptionRule(),
    ]


ALL_RULES = all_rules()
