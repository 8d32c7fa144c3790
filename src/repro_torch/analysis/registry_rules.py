"""Registry conformance rule (port of ``repro/analysis/registry_rules.py``;
DESIGN.md §15): registered implementations satisfy their Protocol,
statically.

The port's extension points all share one shape (``core/engines.py``,
``core/samplers.py``, ``retrieval/engines.py``, ``retrieval/backends.py``,
``analysis/core.py``): a ``typing.Protocol`` class declaring the contract,
a module-level ``register*`` function whose body subscript-assigns into a
``*REGISTRY*`` dict, and implementations registered by decorator (often
stacked with ``@dataclasses.dataclass``).  A non-conforming implementation
today surfaces as an ``AttributeError``/``TypeError`` deep inside a run;
this rule finds the same defect at lint time:

  * a protocol method the implementation never defines (and no base class
    in the module defines);
  * an implementation method whose signature cannot accept the protocol's
    calls — fewer positionals, missing kw-only names, or extra required
    parameters without defaults;
  * a protocol attribute (``name: str`` / ``needs_graph: bool`` …) the
    implementation declares neither at class level (AnnAssign *or* plain
    Assign — sampler strategies use both), nor in ``__init__`` via
    ``self.attr = …``, nor as a property.

Discovery is per-module and purely syntactic: the protocol/register-fn
pairing is inferred, so the rule automatically covers new registries —
including this package's own ``LintRule``/``register_rule``.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import (Finding, Module, Project,
                                       call_name, register_rule)

__all__ = ["Registry", "find_registries", "conformance_findings"]


@dataclasses.dataclass
class Registry:
    """One protocol + register-function pairing in a module."""

    module: Module
    protocol: ast.ClassDef
    register_fn: str
    implementations: List[ast.ClassDef]


def _is_protocol(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = base.attr if isinstance(base, ast.Attribute) else \
            base.id if isinstance(base, ast.Name) else None
        if name == "Protocol":
            return True
    return False


def _is_register_fn(fn: ast.FunctionDef) -> bool:
    """Module-level def that subscript-assigns into a *REGISTRY* dict."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and \
                        isinstance(tgt.value, ast.Name) and \
                        "registry" in tgt.value.id.lower():
                    return True
    return False


def _decorator_names(cls: ast.ClassDef) -> Set[str]:
    out: Set[str] = set()
    for dec in cls.decorator_list:
        node = dec.func if isinstance(dec, ast.Call) else dec
        name = node.attr if isinstance(node, ast.Attribute) else \
            node.id if isinstance(node, ast.Name) else None
        if name:
            out.add(name)
    return out


def find_registries(project: Project) -> List[Registry]:
    """Protocol/register-fn pairs, with their registered implementations
    gathered project-wide (implementations often live in other modules)."""
    registries: List[Registry] = []
    for module in project.modules:
        protocols = [n for n in module.tree.body
                     if isinstance(n, ast.ClassDef) and _is_protocol(n)]
        register_fns = [n.name for n in module.tree.body
                        if isinstance(n, ast.FunctionDef)
                        and _is_register_fn(n)]
        if not protocols or not register_fns:
            continue
        # one protocol per register fn in this codebase; pair them in
        # source order when a module declares several
        for proto, fn_name in zip(protocols, register_fns):
            registries.append(Registry(module=module, protocol=proto,
                                       register_fn=fn_name,
                                       implementations=[]))
    by_fn = {r.register_fn: r for r in registries}
    for module in project.modules:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                for dec in _decorator_names(node):
                    if dec in by_fn:
                        by_fn[dec].implementations.append(node)
            elif isinstance(node, ast.Call):
                # register(MyClass) call form
                name = (call_name(node) or "").split(".")[-1]
                if name in by_fn and node.args and \
                        isinstance(node.args[0], ast.Name):
                    reg = by_fn[name]
                    target = node.args[0].id
                    for n in ast.walk(module.tree):
                        if isinstance(n, ast.ClassDef) and \
                                n.name == target and \
                                n not in reg.implementations:
                            reg.implementations.append(n)
    return registries


def _protocol_members(proto: ast.ClassDef
                      ) -> Tuple[Dict[str, ast.FunctionDef], Set[str]]:
    """(methods, attrs) the protocol declares."""
    methods: Dict[str, ast.FunctionDef] = {}
    attrs: Set[str] = set()
    for item in proto.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not item.name.startswith("__"):
                methods[item.name] = item
        elif isinstance(item, ast.AnnAssign) and \
                isinstance(item.target, ast.Name):
            attrs.add(item.target.id)
        elif isinstance(item, ast.Assign):
            for tgt in item.targets:
                if isinstance(tgt, ast.Name):
                    attrs.add(tgt.id)
    return methods, attrs


def _class_members(cls: ast.ClassDef,
                   classes: Dict[str, ast.ClassDef],
                   seen: Optional[Set[str]] = None
                   ) -> Tuple[Dict[str, ast.FunctionDef], Set[str]]:
    """(methods, attrs) of a class, following same-project base classes.

    Attrs count when declared at class level (AnnAssign or plain Assign —
    sampler strategies use both), assigned to ``self`` in ``__init__``, or
    defined as a property."""
    seen = seen or set()
    seen.add(cls.name)
    methods: Dict[str, ast.FunctionDef] = {}
    attrs: Set[str] = set()
    for base in cls.bases:
        bname = base.attr if isinstance(base, ast.Attribute) else \
            base.id if isinstance(base, ast.Name) else None
        if bname in classes and bname not in seen:
            bm, ba = _class_members(classes[bname], classes, seen)
            methods.update(bm)
            attrs.update(ba)
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            decs = {d.id for d in item.decorator_list
                    if isinstance(d, ast.Name)}
            if "property" in decs or "cached_property" in decs:
                attrs.add(item.name)
            else:
                methods[item.name] = item
            if item.name == "__init__":
                for node in ast.walk(item):
                    if isinstance(node, ast.Attribute) and \
                            isinstance(node.value, ast.Name) and \
                            node.value.id == "self" and \
                            hasattr(node, "ctx") and \
                            isinstance(node.ctx, ast.Store):
                        attrs.add(node.attr)
        elif isinstance(item, ast.AnnAssign) and \
                isinstance(item.target, ast.Name):
            attrs.add(item.target.id)
        elif isinstance(item, ast.Assign):
            for tgt in item.targets:
                if isinstance(tgt, ast.Name):
                    attrs.add(tgt.id)
    return methods, attrs


def _sig(fn: ast.FunctionDef
         ) -> Tuple[List[str], int, Set[str], bool, bool, Set[str]]:
    """(positional names sans self, n_required_positional, kwonly names,
    has_vararg, has_kwarg, required kwonly names)."""
    a = fn.args
    pos = [x.arg for x in list(a.posonlyargs) + list(a.args)]
    if pos and pos[0] in ("self", "cls"):
        pos = pos[1:]
    n_defaults = len(a.defaults)
    n_required = max(0, len(pos) - n_defaults)
    kwonly = {x.arg for x in a.kwonlyargs}
    required_kwonly = {x.arg for x, d in zip(a.kwonlyargs, a.kw_defaults)
                       if d is None}
    return pos, n_required, kwonly, a.vararg is not None, \
        a.kwarg is not None, required_kwonly


def _signature_problem(proto_fn: ast.FunctionDef,
                       impl_fn: ast.FunctionDef) -> Optional[str]:
    """Human-readable incompatibility, or None when compatible."""
    p_pos, _, p_kw, _, _, _ = _sig(proto_fn)
    i_pos, i_req, i_kw, i_var, i_kwarg, i_req_kw = _sig(impl_fn)
    if len(i_pos) < len(p_pos) and not i_var:
        return (f"takes {len(i_pos)} positional args where the protocol "
                f"passes {len(p_pos)} ({', '.join(p_pos)})")
    if i_req > len(p_pos):
        extra = i_pos[len(p_pos):i_req]
        return ("requires extra positional args without defaults: "
                + ", ".join(extra))
    missing_kw = p_kw - i_kw
    if missing_kw and not i_kwarg:
        return ("missing keyword-only args the protocol declares: "
                + ", ".join(sorted(missing_kw)))
    extra_required = i_req_kw - p_kw
    if extra_required:
        return ("requires keyword-only args the protocol never passes: "
                + ", ".join(sorted(extra_required)))
    return None


def conformance_findings(project: Project, rule_id: str,
                         severity: str) -> Iterable[Finding]:
    for reg in find_registries(project):
        proto_methods, proto_attrs = _protocol_members(reg.protocol)
        for impl in reg.implementations:
            impl_module = next(m for m in project.modules
                               if impl in ast.walk(m.tree))
            local_classes = {n.name: n for n in ast.walk(impl_module.tree)
                             if isinstance(n, ast.ClassDef)}
            methods, attrs = _class_members(impl, local_classes)
            for name, proto_fn in proto_methods.items():
                if name not in methods:
                    yield Finding(
                        rule_id, severity, impl_module.path, impl.lineno,
                        symbol=impl.name,
                        message=(
                            f"registered via {reg.register_fn}() but does "
                            f"not implement {reg.protocol.name}.{name}() — "
                            f"this is a runtime AttributeError on first "
                            f"dispatch"))
                    continue
                problem = _signature_problem(proto_fn, methods[name])
                if problem:
                    yield Finding(
                        rule_id, severity, impl_module.path,
                        methods[name].lineno,
                        symbol=f"{impl.name}.{name}",
                        message=(
                            f"signature incompatible with "
                            f"{reg.protocol.name}.{name}: {problem}"))
            for attr in sorted(proto_attrs - attrs - set(methods)):
                yield Finding(
                    rule_id, severity, impl_module.path, impl.lineno,
                    symbol=impl.name,
                    message=(
                        f"missing protocol attribute "
                        f"{reg.protocol.name}.{attr} — declare it at class "
                        f"level or assign it in __init__"))


@register_rule
class RegistryConformanceRule:
    """Every registered implementation satisfies its Protocol."""

    id = "reg-conformance"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        yield from conformance_findings(project, self.id, self.severity)
