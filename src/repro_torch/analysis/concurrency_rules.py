"""Concurrency rules (port of ``repro/analysis/concurrency_rules.py``;
DESIGN.md §15): lock discipline across the serving tier.

The port's threading model is lock-per-object (``self._lock`` guarding
instance state, made by ``obs/locks.make_lock``/``make_rlock``) plus
short-lived worker threads (the live index's compactor). Three things go
wrong in that model, and each is a rule:

  * ``conc-unguarded-write`` (error) / ``conc-unguarded-read`` (warning) —
    an attribute is *guarded* when some non-``__init__`` method assigns it
    inside a ``with self.<lock>`` block; any other method touching it bare
    is racing the guarded writers. Writes are errors (lost updates /
    torn state); reads are warnings (many are benign monotonic probes,
    but each deserves a look or a ``# lint: disable``).
  * ``conc-lock-order`` (error) — the lock-acquisition-order graph: class
    methods may acquire their own lock and, through attribute calls, the
    locks of objects they hold; a cycle in that graph is a deadlock
    waiting for the right interleaving.
  * ``conc-thread-no-surface`` (error) — a ``threading.Thread`` whose
    target's failure is never surfaced: no ``join()`` anywhere in the
    class and no try/except in the worker that stores the error for a
    caller to re-raise (the live index's ``_compact_error`` idiom).

Scope: classes in the packages where the port has threads or locks, and
any fixture tree handed to the rules directly. ``grep threading`` and
``make_lock`` over ``src/repro_torch`` settle the list: ``serve`` (the
scheduler's queue, the tenant cache, the live index and its compaction
worker), ``obs`` (the metrics registry, tracer, recompile sentinel and
debug locks, which any thread may call) and ``kernels`` (``build.py``
compiles sources on several threads, one lock a source). ``distributed``
is not among them: the mesh's cache of process groups
(``collectives.axis_group``) takes no lock, and a compaction worker reads
a copy of it of its own (``serve/ingest.LiveIndex._build``). The port has
no checkpoint worker yet, so ``train`` (the reference's third package)
holds no thread.

What the rules cannot see: they follow ``self.<lock>`` attributes of a
class. A module-level lock (``serve/ingest._FREE_GROUPS``, which guards
the free list of compaction groups kept on a mesh) is outside that model;
the two functions that touch the list (``_take_groups``,
``_give_groups``) each take it around every access, and
``tests/test_torch_serve.py`` drives them through tenant churn.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.core import (ROOT_PACKAGE, Finding, Module,
                                       Project, call_name, dotted_name,
                                       register_rule)

__all__ = ["ClassLocks", "class_locks", "lock_order_graph", "graph_cycle"]

#: packages whose classes are subject to the concurrency rules
_CONCURRENT_PACKAGES = frozenset({"serve", "obs", "kernels"})

#: self-attribute names treated as locks when used as context managers
_LOCK_HINT = "lock"

#: container methods that mutate their receiver — ``self.x.append(...)``
#: is a write to the guarded structure, not a read
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "discard", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "move_to_end", "sort", "reverse"})


def _applies(module: Module) -> bool:
    return module.package in _CONCURRENT_PACKAGES or \
        not module.name.startswith(ROOT_PACKAGE + ".")


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` expression, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_lock_attr(name: Optional[str]) -> bool:
    return name is not None and _LOCK_HINT in name.lower()


def _with_lock_name(stmt: ast.With) -> Optional[str]:
    """Lock attr name when ``stmt`` is ``with self.<lock>: ...``."""
    for item in stmt.items:
        ctx = item.context_expr
        # allow `with self._lock:` and `with self._lock, other:`
        name = _self_attr(ctx)
        if _is_lock_attr(name):
            return name
        # `with self._lock.acquire_timeout(...)`-style wrappers
        if isinstance(ctx, ast.Call):
            inner = _self_attr(ctx.func.value) \
                if isinstance(ctx.func, ast.Attribute) else None
            if _is_lock_attr(inner):
                return inner
    return None


@dataclasses.dataclass
class ClassLocks:
    """Lock discipline facts for one class."""

    name: str
    module: Module
    node: ast.ClassDef
    locks: Set[str]                      # lock attrs ever used in `with`
    guarded: Dict[str, Set[str]]         # attr -> lock names guarding writes
    # (method, attr, line, inside_lock, is_write) access records
    accesses: List[Tuple[str, str, int, bool, bool]]


def _mutation_writes(fn: ast.AST) -> Set[int]:
    """``id()`` of self-attr Attribute nodes written *through*: subscript
    stores (``self.x[k] = v``) and mutator calls (``self.x.append(v)``)."""
    out: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Subscript) and \
                            _self_attr(sub.value) is not None:
                        out.add(id(sub.value))
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS and \
                _self_attr(node.func.value) is not None:
            out.add(id(node.func.value))
    return out


def _method_accesses(fn: ast.AST) -> Iterable[Tuple[str, int, bool, bool]]:
    """(attr, line, inside_lock, is_write) for every self.attr touch."""
    mutated = _mutation_writes(fn)

    def walk(node: ast.AST, inside: bool):
        if isinstance(node, ast.With):
            lock = _with_lock_name(node)
            for child in node.body:
                yield from walk(child, inside or lock is not None)
            for item in node.items:
                yield from walk(item.context_expr, inside)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return  # nested defs audited on their own
        attr = _self_attr(node)
        if attr is not None and not _is_lock_attr(attr):
            is_write = id(node) in mutated or (
                isinstance(node.ctx, (ast.Store, ast.Del))
                if hasattr(node, "ctx") else False)
            yield attr, node.lineno, inside, is_write
        for child in ast.iter_child_nodes(node):
            yield from walk(child, inside)

    for stmt in getattr(fn, "body", []):
        yield from walk(stmt, False)


def class_locks(module: Module, cls: ast.ClassDef) -> ClassLocks:
    """Collect lock facts for one class body."""
    locks: Set[str] = set()
    guarded: Dict[str, Set[str]] = {}
    accesses: List[Tuple[str, str, int, bool, bool]] = []
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mutated = _mutation_writes(item)
        # record which locks each `with` in this method names
        for node in ast.walk(item):
            if isinstance(node, ast.With):
                lock = _with_lock_name(node)
                if lock is not None:
                    locks.add(lock)
                    if item.name != "__init__":
                        for sub in node.body:
                            for n in ast.walk(sub):
                                attr = _self_attr(n)
                                if attr and not _is_lock_attr(attr) and (
                                        id(n) in mutated or
                                        (hasattr(n, "ctx") and isinstance(
                                            n.ctx, ast.Store))):
                                    guarded.setdefault(attr,
                                                       set()).add(lock)
        if item.name == "__init__":
            continue  # construction is single-threaded
        for attr, line, inside, is_write in _method_accesses(item):
            accesses.append((item.name, attr, line, inside, is_write))
    return ClassLocks(name=cls.name, module=module, node=cls,
                      locks=locks, guarded=guarded, accesses=accesses)


def _iter_classes(module: Module) -> Iterable[ast.ClassDef]:
    for node in module.tree.body:
        if isinstance(node, ast.ClassDef):
            yield node


@register_rule
class UnguardedWriteRule:
    """Bare writes to attributes that are elsewhere lock-guarded."""

    id = "conc-unguarded-write"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            if not _applies(module):
                continue
            for cls in _iter_classes(module):
                facts = class_locks(module, cls)
                for method, attr, line, inside, is_write in facts.accesses:
                    if not is_write or inside or attr not in facts.guarded:
                        continue
                    locks = "/".join(sorted(facts.guarded[attr]))
                    yield Finding(
                        self.id, self.severity, module.path, line,
                        symbol=f"{cls.name}.{method}",
                        message=(
                            f"write to self.{attr} outside self.{locks} — "
                            f"other methods only write it under the lock; "
                            f"a bare write races them (lost update / torn "
                            f"state)"))


@register_rule
class UnguardedReadRule:
    """Bare reads of attributes that are elsewhere lock-guarded."""

    id = "conc-unguarded-read"
    severity = "warning"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            if not _applies(module):
                continue
            for cls in _iter_classes(module):
                facts = class_locks(module, cls)
                for method, attr, line, inside, is_write in facts.accesses:
                    if is_write or inside or attr not in facts.guarded:
                        continue
                    locks = "/".join(sorted(facts.guarded[attr]))
                    yield Finding(
                        self.id, self.severity, module.path, line,
                        symbol=f"{cls.name}.{method}",
                        message=(
                            f"read of self.{attr} outside self.{locks} — "
                            f"writers hold the lock; take it (or annotate "
                            f"why a stale/torn read is safe)"))


# ---------------------------------------------------------------------------
# Lock-order graph
# ---------------------------------------------------------------------------


def _init_fn(cls: ast.ClassDef) -> Optional[ast.FunctionDef]:
    for item in cls.body:
        if isinstance(item, ast.FunctionDef) and item.name == "__init__":
            return item
    return None


def _self_param_flow(classes: Dict[str, Tuple["Module", ast.ClassDef]]
                     ) -> Dict[Tuple[str, str], str]:
    """(callee_class, param) -> caller class, from ``Callee(self, ...)``
    call sites anywhere inside a class body — the caller's type flows
    into the callee's constructor parameter."""
    params: Dict[str, List[str]] = {}
    for name, (_, cls) in classes.items():
        init = _init_fn(cls)
        if init is not None:
            params[name] = [a.arg for a in init.args.args[1:]]
    flow: Dict[Tuple[str, str], str] = {}
    for caller, (_, cls) in classes.items():
        for node in ast.walk(cls):
            if not isinstance(node, ast.Call):
                continue
            callee = (call_name(node) or "").split(".")[-1]
            if callee not in params:
                continue
            for i, arg in enumerate(node.args):
                if isinstance(arg, ast.Name) and arg.id == "self" \
                        and i < len(params[callee]):
                    flow[(callee, params[callee][i])] = caller
            for kw in node.keywords:
                if isinstance(kw.value, ast.Name) and \
                        kw.value.id == "self" and kw.arg in params[callee]:
                    flow[(callee, kw.arg)] = caller
    return flow


def _init_attr_classes(cls: ast.ClassDef, known: Set[str],
                       param_flow: Optional[Dict[Tuple[str, str], str]] = None
                       ) -> Dict[str, str]:
    """attr -> class name, from ``self.attr = ClassName(...)`` in
    __init__, ``self.attr = param`` with a class-typed annotation, or a
    param another class passed ``self`` into (``param_flow``)."""
    out: Dict[str, str] = {}
    init = _init_fn(cls)
    if init is None:
        return out
    param_cls: Dict[str, str] = {}          # __init__ param -> class name
    for a in init.args.args[1:] + init.args.kwonlyargs:
        ann = a.annotation
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            ann_name = ann.value.split(".")[-1].strip("'\" ")
        else:
            ann_name = (dotted_name(ann) or "").split(".")[-1] if ann else ""
        if ann_name in known:
            param_cls[a.arg] = ann_name
        elif param_flow and (cls.name, a.arg) in param_flow:
            param_cls[a.arg] = param_flow[(cls.name, a.arg)]
    for node in ast.walk(init):
        if not isinstance(node, ast.Assign):
            continue
        callee = None
        if isinstance(node.value, ast.Call):
            callee = (call_name(node.value) or "").split(".")[-1]
        elif isinstance(node.value, ast.Name):
            callee = param_cls.get(node.value.id)
        if callee not in known:
            continue
        for tgt in node.targets:
            attr = _self_attr(tgt)
            if attr is not None:
                out[attr] = callee
    return out


def lock_order_graph(project: Project) -> Dict[str, Set[str]]:
    """Directed edges ``ClassA.lock -> ClassB.lock`` meaning: some method
    may acquire A's lock and, while holding it, reach code that acquires
    B's lock (a direct nested ``with``, or a call on an attribute whose
    class takes its own lock in that method)."""
    classes: Dict[str, Tuple[Module, ast.ClassDef]] = {}
    for module in project.modules:
        if not _applies(module):
            continue
        for cls in _iter_classes(module):
            classes[cls.name] = (module, cls)

    # which methods of each class acquire that class's own lock
    acquiring: Dict[str, Set[str]] = {}
    for name, (module, cls) in classes.items():
        facts = class_locks(module, cls)
        methods = set()
        for item in cls.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(item):
                    if isinstance(node, ast.With) and \
                            _with_lock_name(node) is not None:
                        methods.add(item.name)
                        break
        if facts.locks:
            acquiring[name] = methods

    edges: Dict[str, Set[str]] = {}
    param_flow = _self_param_flow(classes)
    for name, (module, cls) in classes.items():
        if name not in acquiring:
            continue
        attr_cls = _init_attr_classes(cls, set(classes), param_flow)
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(item):
                if not isinstance(node, ast.With) or \
                        _with_lock_name(node) is None:
                    continue
                # inside this class's lock: find calls into held objects
                for sub in node.body:
                    for n in ast.walk(sub):
                        if not isinstance(n, ast.Call) or \
                                not isinstance(n.func, ast.Attribute):
                            continue
                        owner = _self_attr(n.func.value)
                        if owner is None or owner not in attr_cls:
                            continue
                        callee_cls = attr_cls[owner]
                        if n.func.attr in acquiring.get(callee_cls, ()):
                            edges.setdefault(name, set()).add(callee_cls)
    return edges


def graph_cycle(edges: Dict[str, Set[str]]) -> Optional[List[str]]:
    """One cycle as a node list (closed), or None."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in
             set(edges) | {v for vs in edges.values() for v in vs}}
    stack: List[str] = []

    def visit(n: str) -> Optional[List[str]]:
        color[n] = GREY
        stack.append(n)
        for m in sorted(edges.get(n, ())):
            if color[m] == GREY:
                i = stack.index(m)
                return stack[i:] + [m]
            if color[m] == WHITE:
                found = visit(m)
                if found:
                    return found
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(color):
        if color[n] == WHITE:
            found = visit(n)
            if found:
                return found
    return None


@register_rule
class LockOrderRule:
    """Cycles in the cross-class lock-acquisition-order graph."""

    id = "conc-lock-order"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        edges = lock_order_graph(project)
        cycle = graph_cycle(edges)
        if cycle is None:
            return
        # anchor the finding at the first class in the cycle
        first = cycle[0]
        for module in project.modules:
            for cls in _iter_classes(module):
                if cls.name == first:
                    yield Finding(
                        self.id, self.severity, module.path, cls.lineno,
                        symbol=first,
                        message=(
                            "lock-acquisition-order cycle: "
                            + " -> ".join(cycle)
                            + " — two threads taking these locks in "
                              "opposite orders deadlock; impose a single "
                              "acquisition order or drop to one lock"))
                    return


# ---------------------------------------------------------------------------
# Thread failure surfacing
# ---------------------------------------------------------------------------


def _thread_targets(cls: ast.ClassDef) -> List[Tuple[str, int, Optional[str]]]:
    """(creating_method, line, target_method) per Thread(...) construction."""
    out = []
    for item in cls.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(item):
            if not isinstance(node, ast.Call):
                continue
            callee = (call_name(node) or "").split(".")[-1]
            if callee != "Thread":
                continue
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    t = _self_attr(kw.value)
                    if t is not None:
                        target = t
                    elif isinstance(kw.value, ast.Name):
                        target = kw.value.id
            out.append((item.name, node.lineno, target))
    return out


def _has_join(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "join":
            return True
    return False


def _worker_surfaces(cls: ast.ClassDef, target: Optional[str]) -> bool:
    """True when the worker stores/raises failures: its body has a
    try/except whose handler assigns to self.* or re-raises/logs."""
    if target is None:
        return False
    for item in cls.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                item.name == target:
            for node in ast.walk(item):
                if isinstance(node, ast.Try) and node.handlers:
                    for handler in node.handlers:
                        for n in ast.walk(handler):
                            if _self_attr(n) is not None and \
                                    hasattr(n, "ctx") and \
                                    isinstance(n.ctx, ast.Store):
                                return True
                            if isinstance(n, (ast.Raise,)):
                                return True
                            if isinstance(n, ast.Call) and \
                                    (call_name(n) or "").split(".")[-1] in (
                                        "error", "exception", "critical"):
                                return True
    return False


@register_rule
class ThreadNoSurfaceRule:
    """Threads whose failures vanish: no join and no error capture."""

    id = "conc-thread-no-surface"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            if not _applies(module):
                continue
            for cls in _iter_classes(module):
                for method, line, target in _thread_targets(cls):
                    if _has_join(cls) or _worker_surfaces(cls, target):
                        continue
                    yield Finding(
                        self.id, self.severity, module.path, line,
                        symbol=f"{cls.name}.{method}",
                        message=(
                            "thread started without failure surfacing: the "
                            "class never join()s it and the worker has no "
                            "try/except storing the error — a crash here "
                            "is silent; keep the LiveIndex idiom "
                            "(store exc in the worker, re-raise on "
                            "the next call/join)"))
