"""The port's lint engine: module loading, suppressions, baseline, reporting.

The JAX package's ``analysis/engine.py`` in the port: stdlib ``ast`` only,
no third-party lint framework, so the linter runs in any checkout. Rules
live in :mod:`.rules`; this module gives them a parsed, cross-referenced
view of one file (:class:`LintedModule`) and owns everything around a
finding's lifecycle:

- **Suppressions**: ``# tpulint: disable=TPL002[,TPL005] <reason>`` on
  the offending line (or on a comment-only line directly above it)
  silences those rules there; ``disable=all`` silences every rule. The
  reason is required: a suppression without one is itself a finding
  (``TPL000``), so every silenced site says why.
- **Baseline**: :class:`Baseline` reads grandfathered findings from a JSON
  file in the JAX package's format, keyed by a line-number-free
  fingerprint (rule | path | scope | message), so pure line drift never
  resurrects a blessed finding. The CLI takes no baseline: the port's
  tree needs none, and ``--strict`` fails on any live finding.
- **Output**: a finding renders as one human-readable line
  (:meth:`Finding.render`, what the CLI prints) or as a JSON object
  (:meth:`Finding.to_dict`, the baseline file's entry format).
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator

SUPPRESS_RE = re.compile(
    r"#\s*tpulint:\s*disable=([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)(.*)$"
)
UNEXPLAINED_RULE = "TPL000"

SKIP_DIR_NAMES = {
    "__pycache__", ".git", "build", "dist", ".eggs", "node_modules",
}


@dataclass
class Finding:
    """One rule violation at one location."""

    rule: str
    path: str       # repo-relative posix path
    line: int
    col: int
    message: str
    scope: str = ""         # dotted enclosing class/def chain
    suppressed: bool = False
    baselined: bool = False
    note: str = ""          # baseline justification when baselined

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity: stable across pure line drift."""
        raw = f"{self.rule}|{self.path}|{self.scope}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        tag = ""
        if self.suppressed:
            tag = " [suppressed]"
        elif self.baselined:
            tag = " [baselined]"
        where = f"{self.path}:{self.line}:{self.col}"
        scope = f" in {self.scope}" if self.scope else ""
        return f"{where}: {self.rule} {self.message}{scope}{tag}"

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "scope": self.scope,
            "fingerprint": self.fingerprint,
        }
        if self.suppressed:
            d["suppressed"] = True
        if self.baselined:
            d["baselined"] = True
            if self.note:
                d["note"] = self.note
        return d


class Rule:
    """Base class of one lint rule.

    Subclasses set ``id`` (``TPL00x``), ``name`` (short kebab slug) and
    ``doc`` (one paragraph: what it enforces and why), and implement
    :meth:`check` yielding findings. ``self.finding`` stamps location and
    scope so rules only supply the message.
    """

    id: str = ""
    name: str = ""
    doc: str = ""

    def check(self, mod: "LintedModule") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: "LintedModule", node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.id,
            path=mod.relpath,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
            scope=mod.scope_of(node),
        )


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, '' for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


class LintedModule:
    """One parsed file plus the cross-references every rule needs."""

    def __init__(self, relpath: str, source: str):
        self.relpath = relpath.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.suppressions = self._parse_suppressions()
        # names imported in this module: local alias -> dotted origin
        self.imports: dict[str, str] = {}
        for n in ast.walk(self.tree):
            if isinstance(n, ast.Import):
                for a in n.names:
                    self.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(n, ast.ImportFrom) and n.module:
                for a in n.names:
                    self.imports[a.asname or a.name] = f"{n.module}.{a.name}"

    # -- location helpers ---------------------------------------------------

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def scope_of(self, node: ast.AST) -> str:
        names = [
            a.name
            for a in self.ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        ]
        return ".".join(reversed(names))

    def enclosing_function(self, node: ast.AST) -> ast.FunctionDef | None:
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    # -- name resolution ----------------------------------------------------

    def resolves_to(self, node: ast.AST, dotted: str) -> bool:
        """Does ``node`` (Name/Attribute) denote ``dotted`` (e.g.
        ``torch.cuda.synchronize``), accounting for ``import torch``,
        ``from torch import cuda`` and aliases?"""
        got = dotted_name(node)
        if not got:
            return False
        if got == dotted:
            return True
        head, _, rest = got.partition(".")
        origin = self.imports.get(head)
        if origin:
            resolved = origin + ("." + rest if rest else "")
            if resolved == dotted:
                return True
        return False

    def call_is(self, call: ast.Call, dotted: str) -> bool:
        return self.resolves_to(call.func, dotted)

    # -- suppressions -------------------------------------------------------

    def _parse_suppressions(self) -> dict[int, set[str]]:
        out: dict[int, set[str]] = {}
        self.unexplained: list[int] = []  # suppression lines with no reason
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if not m:
                continue
            if not m.group(2).strip().lstrip("#-:;\u2014").strip():
                self.unexplained.append(i)
            rules = {r.strip().upper() for r in m.group(1).split(",") if r.strip()}
            target = i
            if line.lstrip().startswith("#"):
                # comment-only line: applies to the next source line
                target = i + 1
            out.setdefault(target, set()).update(rules)
        return out

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressions.get(finding.line, ())
        return bool(rules) and ("ALL" in rules or finding.rule in rules)


@dataclass
class Baseline:
    """A set of blessed findings in the JAX package's baseline format. The
    port's CLI reads none: it is the engine's, for a caller that
    grandfathers findings while a rule is introduced."""

    path: str = ""
    entries: dict[str, dict] = field(default_factory=dict)  # fingerprint -> entry

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not path or not os.path.exists(path):
            return cls(path=path)
        with open(path) as f:
            doc = json.load(f)
        entries = {e["fingerprint"]: e for e in doc.get("entries", [])}
        return cls(path=path, entries=entries)

    def apply(self, findings: list[Finding]) -> None:
        """Mark baselined findings in place."""
        for f in findings:
            e = self.entries.get(f.fingerprint)
            if e is not None:
                f.baselined = True
                f.note = e.get("note", "")


# -- running ----------------------------------------------------------------


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(
                d for d in dirs
                if d not in SKIP_DIR_NAMES and not d.endswith(".egg-info")
            )
            for fn in sorted(files):
                if fn.endswith(".py"):
                    yield os.path.join(root, fn)


def lint_source(
    source: str, relpath: str, rules: Iterable[Rule]
) -> list[Finding]:
    """Lint one in-memory module (the test-fixture entry point)."""
    mod = LintedModule(relpath, source)
    findings: list[Finding] = []
    for rule in rules:
        for f in rule.check(mod):
            f.suppressed = mod.is_suppressed(f)
            findings.append(f)
    for line in mod.unexplained:
        findings.append(Finding(
            rule=UNEXPLAINED_RULE, path=mod.relpath, line=line, col=0,
            message="tpulint suppression without a reason: say why on the "
            "same line, after the rule list",
        ))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_paths(
    paths: Iterable[str],
    rules: Iterable[Rule],
    *,
    root: str = ".",
) -> tuple[list[Finding], list[str]]:
    """Lint files/trees. Returns (findings, unparseable-file errors)."""
    rules = list(rules)
    findings: list[Finding] = []
    errors: list[str] = []
    for path in iter_py_files(paths):
        relpath = os.path.relpath(path, root)
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            findings.extend(lint_source(source, relpath, rules))
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{relpath}: {type(e).__name__}: {e}")
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, errors
