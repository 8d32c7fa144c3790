"""Contract analyzer core (port of ``repro/analysis/core.py``; DESIGN.md
§15): findings, rule registry, project loader, suppressions, baseline.

The port's layers rest on invariants that would otherwise live only in
prose — "steady state launches no new kernel shape" (scheduler bucket
set), "an append writes only rows no snapshot can see" (LiveIndex), "lock
discipline across serve/" — and on registry protocols whose violations
surface as runtime ``AttributeError``. This package machine-checks those
contracts: each contract family is a registered :class:`LintRule` behind
one ``check(project)`` protocol (mirroring ``core/engines.py`` /
``core/samplers.py``), and ``launch/lint.py`` runs the registry over a
parsed :class:`Project`.

Rule families (each in its own module, imported by :func:`load_default_rules`):

  * ``analysis/torch_rules.py``       — host syncs and tensor branches in
                                        hot code, unbounded launch shapes,
                                        in-place write safety.
  * ``analysis/concurrency_rules.py`` — lock discipline, lock-order graph,
                                        thread failure surfacing.
  * ``analysis/registry_rules.py``    — registered classes implement their
                                        Protocol (signatures included).
  * ``analysis/imports.py``           — package import cycles + layering.

Suppression: a finding is silenced by ``# lint: disable=<rule-id>`` (or a
bare ``# lint: disable``) on the flagged line or the line directly above.
Suppressions are for *reviewed* exceptions — the analyzer is advisory about
idioms it cannot prove safe, and the comment is the audit trail.

Baseline: :func:`save_baseline` persists finding fingerprints (rule + path
+ symbol + message — line numbers excluded, so unrelated edits do not churn
it); :func:`new_findings` filters a run against it. CI fails on any
error-severity finding not in the committed baseline.

Like the rest of the port, this package imports nothing of ``repro``: the
reference's analyzer imports no JAX, but the port keeps its own copy.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, \
    Tuple, runtime_checkable

__all__ = [
    "ROOT_PACKAGE", "SEVERITIES", "Finding", "Module", "Project", "LintRule",
    "register_rule", "get_rule", "available_rules", "analyze",
    "load_default_rules", "load_baseline", "save_baseline", "new_findings",
    "dotted_name", "call_name",
]

#: the package whose modules the rules know by their subpackage
ROOT_PACKAGE = "repro_torch"

#: severity rank — exit-code policy and report ordering
SEVERITIES: Dict[str, int] = {"info": 0, "warning": 1, "error": 2}

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable(?:=([\w\-, ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer finding, anchored to ``path:line``."""

    rule: str
    severity: str
    path: str
    line: int
    message: str
    symbol: str = ""   # enclosing def/class qualname, for stable baselines

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity (baseline key).  The path is keyed
        by its trailing package-relative form so absolute and relative
        invocations agree on the same fingerprint."""
        path = self.path.replace(os.sep, "/")
        for marker in ("/src/", "/tests/"):
            if marker in path:
                path = path.split(marker, 1)[1]
                path = marker.strip("/") + "/" + path
                break
        else:
            path = path.lstrip("/")
        raw = "|".join((self.rule, path, self.symbol, self.message))
        return hashlib.sha1(raw.encode()).hexdigest()[:12]

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "fingerprint": self.fingerprint}

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"{self.rule}: {self.message}{sym}")


@dataclasses.dataclass
class Module:
    """One parsed source file."""

    path: str             # filesystem path, as discovered
    name: str             # dotted module name (repro_torch.serve.ingest)
    tree: ast.Module
    lines: List[str]      # raw source lines, 0-indexed

    @property
    def package(self) -> str:
        """Top-level subpackage under ``repro_torch`` (a root module's own
        name, '' for the package's ``__init__``), else the first dotted
        component (fixture trees)."""
        parts = self.name.split(".")
        if parts[0] == ROOT_PACKAGE:
            return parts[1] if len(parts) > 1 else ""
        return parts[0]

    def suppressed(self, line: int, rule_id: str) -> bool:
        """True when ``# lint: disable[=rule[,rule]]`` covers ``line``."""
        for lineno in (line, line - 1):
            if not 1 <= lineno <= len(self.lines):
                continue
            m = _SUPPRESS_RE.search(self.lines[lineno - 1])
            if m is None:
                continue
            if m.group(1) is None:
                return True
            rules = {r.strip() for r in m.group(1).split(",")}
            if rule_id in rules:
                return True
        return False


def _module_name(path: str) -> str:
    """Dotted name by walking up through ``__init__.py`` package dirs; the
    first directory without one is the import root (``src`` for the repo,
    a tmp dir for test fixtures)."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if parts[0] == "__init__":
        parts = parts[1:] or [os.path.basename(os.path.dirname(path))]
    return ".".join(reversed(parts))


class Project:
    """A set of parsed modules the rules run over."""

    def __init__(self, modules: Sequence[Module]):
        self.modules: List[Module] = sorted(modules, key=lambda m: m.path)
        self.by_name: Dict[str, Module] = {m.name: m for m in self.modules}

    @classmethod
    def load(cls, paths: Sequence[str]) -> "Project":
        """Parse every ``.py`` under the given files/directories."""
        files: List[str] = []
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, names in os.walk(p):
                    dirnames[:] = [d for d in dirnames
                                   if d != "__pycache__"]
                    files.extend(os.path.join(dirpath, n)
                                 for n in names if n.endswith(".py"))
            elif p.endswith(".py"):
                files.append(p)
            else:
                raise ValueError(f"not a python file or directory: {p!r}")
        modules = []
        for f in sorted(set(files)):
            with open(f, encoding="utf-8") as fh:
                src = fh.read()
            modules.append(Module(path=f, name=_module_name(f),
                                  tree=ast.parse(src, filename=f),
                                  lines=src.splitlines()))
        return cls(modules)


# ---------------------------------------------------------------------------
# Rule registry (the core/engines.py pattern)
# ---------------------------------------------------------------------------


@runtime_checkable
class LintRule(Protocol):
    """One contract checker: scans a project, yields findings."""

    id: str
    severity: str

    def check(self, project: Project) -> Iterable[Finding]:
        ...


# named *REGISTRY* so registry_rules finds LintRule/register_rule too
_RULE_REGISTRY: Dict[str, LintRule] = {}


def register_rule(cls):
    """Class decorator: instantiate and register a rule under its id."""
    rule = cls()
    _RULE_REGISTRY[rule.id] = rule
    return cls


def get_rule(rule_id: str) -> LintRule:
    try:
        return _RULE_REGISTRY[rule_id]
    except KeyError:
        raise ValueError(
            f"unknown lint rule {rule_id!r}; registered rules: "
            f"{', '.join(available_rules())}") from None


def available_rules() -> tuple:
    return tuple(sorted(_RULE_REGISTRY))


def load_default_rules() -> tuple:
    """Import the built-in rule modules (their decorators register) and
    return the registered rule ids."""
    from repro_torch.analysis import concurrency_rules  # noqa: F401
    from repro_torch.analysis import imports            # noqa: F401
    from repro_torch.analysis import registry_rules     # noqa: F401
    from repro_torch.analysis import torch_rules        # noqa: F401
    return available_rules()


def analyze(project: Project,
            rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run rules over the project; suppression comments applied; findings
    ordered (path, line, rule)."""
    if not _RULE_REGISTRY:
        load_default_rules()
    ids = list(rules) if rules is not None else list(available_rules())
    by_path = {m.path: m for m in project.modules}
    findings: List[Finding] = []
    for rule_id in ids:
        rule = get_rule(rule_id)
        for f in rule.check(project):
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f.line, f.rule):
                continue
            findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    """Persist finding fingerprints (sorted, line-free) as the accepted set."""
    payload = {
        "version": 1,
        "findings": sorted(
            ({"fingerprint": f.fingerprint, "rule": f.rule, "path": f.path,
              "severity": f.severity, "message": f.message}
             for f in findings), key=lambda d: d["fingerprint"]),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=2)
        fh.write("\n")


def load_baseline(path: str) -> frozenset:
    """Accepted fingerprints (empty set when the file does not exist)."""
    if not os.path.exists(path):
        return frozenset()
    with open(path) as fh:
        payload = json.load(fh)
    return frozenset(d["fingerprint"] for d in payload.get("findings", ()))


def new_findings(findings: Sequence[Finding],
                 baseline: frozenset) -> List[Finding]:
    return [f for f in findings if f.fingerprint not in baseline]


# ---------------------------------------------------------------------------
# Shared AST helpers
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted name of a call target ('functools.partial', 'torch.where')."""
    return dotted_name(call.func)


def iter_functions(tree: ast.AST
                   ) -> Iterable[Tuple[str, ast.AST, Optional[ast.ClassDef]]]:
    """Yield (qualname, funcdef, enclosing_class) for every def, including
    nested ones (nested defs carry the outer qualname prefix)."""

    def walk(node: ast.AST, prefix: str, cls: Optional[ast.ClassDef]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                yield qual, child, cls
                yield from walk(child, qual + ".", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.", child)
            else:
                yield from walk(child, prefix, cls)

    yield from walk(tree, "", None)


def arg_names(fn: ast.AST) -> List[str]:
    """Positional + kw-only parameter names of a def or lambda."""
    a = fn.args
    return [x.arg for x in
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)]
