"""PyTorch contract rules (DESIGN.md §15), the port's counterpart of the
reference's ``repro/analysis/jax_rules.py``: host syncs in hot code,
unbounded launch shapes, and in-place write safety.

Rule family 1 — implicit and explicit host syncs inside hot functions:

  * ``torch-host-sync``      (error)   ``.item()``/``.tolist()``/``.cpu()``/
    ``.numpy()`` or ``float()``/``int()``/``bool()`` of a tensor: the host
    waits for the device's queue to drain (the reference's
    ``jax-host-cast``).
  * ``torch-tensor-branch``  (error)   ``if``/``while``/ternary/``assert``
    on a tensor-valued expression: Python reads the value, an implicit
    sync (the reference's ``jax-traced-branch``); keep it on the device
    with ``torch.where``, or read it once, deliberately.
  * ``torch-unbounded-launch`` (warning) a launch-parameter argument (an
    ``int``-annotated parameter) of a kernel wrapper (a public function of
    a ``kernels/*/ops.py`` module), or any keyword of ``tuning.resolve``,
    whose value set is not provably bounded (the reference's
    ``jax-unbounded-static``). The launch shape of a wrapper is its int
    arguments (``Kernel.shapes``): each new value is a launch shape the
    serving warm-up never saw, counted by ``--recompile-check``'s
    ``steady_new_shapes``. Values are known-static when they are literals,
    ALL_CAPS constants, shapes/dims, ``min(...)`` clamps, bucket lookups
    (``tuning.resolve`` and the ``kernels/tuning.py`` size buckets), or the
    tuned block kwargs (``tuning.DEFAULTS``, a finite table).

Hot functions are declared here (:data:`HOT_CODE`), since the port has no
trace boundary to find them by: the kernel wrappers, the scoring backends,
the search step of ``retrieval/search_core.py`` and the serving tier.

Rule family 2 — in-place write safety (the reference's donation rules):

  * ``torch-inplace-reuse``  (error)   an alias or view of a tensor (``v =
    x``, a basic slice, ``x.view``/``reshape``/``t``/``T``/...) read after
    an in-place write to that tensor in the same function (``copy_`` or
    another ``*_`` method, a subscript assignment, an augmented assignment
    of a tensor, ``out=``): the read sees the new values, where the alias
    was usually taken to keep the old ones (the reference's
    ``jax-donated-reuse``).
  * ``serve-inplace-append`` (error)   the LiveIndex contract (the
    reference's ``serve-donated-append``): in ``serve/`` modules an
    in-place slice write into a buffer attribute (``self.<buf>[a:b] = ...``
    or ``self.<buf>[a:b].copy_(...)``) must run inside ``with
    self.<lock>``, and its start must be a row count read under that lock
    before the block updates any state: then the rows it writes lie at or
    past the count every earlier snapshot holds, which masks them
    (serve/ingest.py). Anywhere else the write may land under a search
    that is reading those rows.

Tensor-ness is a forward, lexical dataflow over each function body,
seeded by parameters annotated ``torch.Tensor`` and by names assigned from
``torch.*`` calls (the tensor-making namespaces) or tensor methods; names
assigned from tensor-valued expressions join it, names re-bound to host
values leave it. ``.shape``/``.dtype``/``.device``/``len()``/``.size()``
projections are host metadata, and ``.item()``/``.tolist()``/``.cpu()``/
``.numpy()`` end it (those are the syncs the first rule reports). A call
of any other function is tensor-valued when an argument is, unless the
function is one of the module's own whose return annotation names no
tensor. Deliberately intraprocedural, with ``# lint: disable=`` as the
reviewed escape hatch.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.concurrency_rules import _self_attr, \
    _with_lock_name
from repro_torch.analysis.core import (ROOT_PACKAGE, Finding, Module,
                                       Project, call_name,
                                       dotted_name, iter_functions,
                                       register_rule)

__all__ = ["HOT_CODE", "TUNED_BLOCK_KWARGS", "hot_functions",
           "kernel_wrappers"]


def _tuned_block_kwargs() -> frozenset:
    """Block-kwarg names the autotuner dispatches (from kernels/tuning.py,
    so tuned kwargs are known-static: ``resolve`` draws them from a finite
    table keyed by the SIZE_BUCKETS boundaries)."""
    from repro_torch.kernels.tuning import DEFAULTS
    return frozenset(k for params in DEFAULTS.values() for k in params)


TUNED_BLOCK_KWARGS = _tuned_block_kwargs()

#: the port's hot code: module (relative to the root package, fnmatch
#: pattern) -> the functions in it that are hot (qualnames), None for all.
#: Kernel wrappers, backends and the search step run once a query chunk;
#: serve/ runs once a tick or a request.
HOT_CODE: Dict[str, Optional[Tuple[str, ...]]] = {
    "kernels.*.ops": None,
    "retrieval.backends": None,
    "retrieval.search_core": ("SearchSession._search_chunk",
                              "SearchSession.search_scored",
                              "SearchSession.search"),
    "serve.*": None,
}

#: attribute projections of a tensor that are host metadata (no sync)
_STATIC_ATTRS = frozenset({
    "shape", "ndim", "dtype", "device", "is_cuda", "is_sparse", "layout",
    "itemsize", "nbytes", "requires_grad", "is_leaf", "names"})
#: tensor methods that return host metadata without a sync
_STATIC_METHODS = frozenset({
    "size", "dim", "ndimension", "numel", "nelement", "element_size",
    "is_contiguous", "data_ptr", "stride", "storage_offset",
    "is_floating_point", "is_complex", "get_device", "is_pinned", "type"})
#: tensor methods that copy to the host (the syncs)
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_CASTS = frozenset({"float", "int", "bool", "complex"})
#: builtins whose result is a host value whatever their arguments
_HOST_BUILTINS = frozenset({
    "len", "isinstance", "issubclass", "range", "zip", "enumerate", "str",
    "repr", "type", "id", "hasattr", "getattr", "callable", "print",
    "sorted", "hash", "format"}) | _HOST_CASTS
#: torch.* submodules whose functions make tensors
_TENSOR_NAMESPACES = frozenset({"nn.functional", "linalg", "fft",
                                "special"})
#: torch.* functions that make no tensor
_HOST_TORCH = frozenset({
    "device", "dtype", "iinfo", "finfo", "Size", "Generator", "no_grad",
    "inference_mode", "enable_grad", "set_grad_enabled", "equal",
    "allclose", "manual_seed", "compile", "numel", "result_type",
    "promote_types", "can_cast", "use_deterministic_algorithms"})
#: tensor methods that return a view of (or the same memory as) the receiver
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "reshape_as", "transpose", "t", "permute",
    "expand", "expand_as", "narrow", "select", "unsqueeze", "squeeze",
    "flatten", "unflatten", "as_strided", "diagonal", "movedim", "moveaxis",
    "swapaxes", "swapdims", "detach", "contiguous", "unfold", "real",
    "imag"})
_VIEW_ATTRS = frozenset({"T", "mT", "H", "mH", "data", "real", "imag"})


def relative_name(module: Module) -> str:
    """The module's dotted name below the root package (``serve.ingest``);
    a fixture tree's whole name (its top directory plays a package)."""
    parts = module.name.split(".")
    if parts[0] == ROOT_PACKAGE:
        return ".".join(parts[1:])
    return module.name


def _hot_spec(module: Module):
    rel = relative_name(module)
    for pattern, quals in HOT_CODE.items():
        if fnmatch.fnmatchcase(rel, pattern):
            return True, quals
    return False, None


def hot_functions(module: Module) -> List[Tuple[str, ast.AST]]:
    """(qualname, def) of the module's hot functions (:data:`HOT_CODE`)."""
    hot, quals = _hot_spec(module)
    if not hot:
        return []
    return [(q, fn) for q, fn, _cls in iter_functions(module.tree)
            if quals is None or q in quals]


def _torch_aliases(module: Module) -> Dict[str, str]:
    """Local name -> dotted torch module it binds (``F`` ->
    ``torch.nn.functional``), from the module's imports."""
    out: Dict[str, str] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "torch":
                    out[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else "torch"
        elif isinstance(node, ast.ImportFrom) and not node.level and \
                (node.module or "").split(".")[0] == "torch":
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _returns_no_tensor(fn: ast.AST) -> bool:
    ann = getattr(fn, "returns", None)
    if ann is None:
        return False
    text = ast.unparse(ann)
    return "Tensor" not in text and text not in ("Any", "object")


class _TensorFlow:
    """Forward lexical dataflow: which names hold tensors."""

    def __init__(self, fn: ast.AST, aliases: Dict[str, str],
                 host_fns: Set[str]):
        self.aliases = aliases
        self.host_fns = host_fns
        self.tensors: Set[str] = set()
        args = fn.args
        for a in list(args.posonlyargs) + list(args.args) + \
                list(args.kwonlyargs):
            if a.annotation is not None and \
                    "Tensor" in ast.unparse(a.annotation):
                self.tensors.add(a.arg)

    def _resolved(self, name: str) -> str:
        head, _, rest = name.partition(".")
        base = self.aliases.get(head)
        if base is None:
            return name
        return f"{base}.{rest}" if rest else base

    def _torch_call(self, name: str) -> Optional[bool]:
        """True/False for a torch.* callee (makes a tensor or not), None
        for any other."""
        full = self._resolved(name)
        if not full.startswith("torch."):
            return None
        rest = full[len("torch."):]
        space, _, fn = rest.rpartition(".")
        if space:
            return space in _TENSOR_NAMESPACES
        return not (fn in _HOST_TORCH or fn.startswith(("is_", "get_",
                                                        "set_")))

    def expr(self, node: ast.AST) -> bool:
        """True when ``node`` evaluates to a tensor (on some device)."""
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Call):
            func = node.func
            name = call_name(node) or ""
            if isinstance(func, ast.Attribute) and self.expr(func.value):
                return func.attr not in _HOST_METHODS | _STATIC_METHODS
            made = self._torch_call(name) if name else None
            if made is not None:
                return made
            if name in _HOST_BUILTINS or name in self.host_fns or \
                    name.split(".")[-1] in ("size_bucket", "resolve"):
                return False
            return any(self.expr(a) for a in node.args) or \
                any(self.expr(k.value) for k in node.keywords)
        if isinstance(node, (ast.BinOp, ast.BoolOp, ast.Compare,
                             ast.UnaryOp, ast.Subscript, ast.IfExp,
                             ast.Tuple, ast.List, ast.Starred)):
            return any(self.expr(c) for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr)
                       and not (isinstance(node, ast.Subscript)
                                and c is node.slice))
        return False

    def feed(self, stmt: ast.stmt) -> None:
        """Propagate through one assignment statement."""
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            if stmt.value is None:
                return
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            tensor = self.expr(stmt.value)
            for tgt in targets:
                for name in _target_names(tgt):
                    if tensor:
                        self.tensors.add(name)
                    else:
                        self.tensors.discard(name)
        elif isinstance(stmt, ast.AugAssign) and self.expr(stmt.value) and \
                isinstance(stmt.target, ast.Name):
            self.tensors.add(stmt.target.id)


def _target_names(tgt: ast.AST) -> List[str]:
    """Names an assignment target binds (not those inside a subscript or
    attribute target, which it reads)."""
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, ast.Starred):
        return _target_names(tgt.value)
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [n for e in tgt.elts for n in _target_names(e)]
    return []


def _is_none_check(test: ast.AST) -> bool:
    return (isinstance(test, ast.Compare)
            and any(isinstance(op, (ast.Is, ast.IsNot))
                    for op in test.ops))


def _body_statements(fn: ast.AST) -> Iterable[ast.stmt]:
    """Statements of a def in source order, skipping nested defs (they are
    hot on their own, if at all)."""

    def walk(stmts):
        for s in stmts:
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
                continue
            yield s
            for field in ("body", "orelse", "finalbody", "handlers"):
                for item in getattr(s, field, None) or ():
                    if isinstance(item, ast.ExceptHandler):
                        yield from walk(item.body)
                    elif isinstance(item, ast.stmt):
                        yield from walk([item])

    yield from walk(getattr(fn, "body", []))


def _own_nodes(stmt: ast.stmt) -> Iterable[ast.AST]:
    """The nodes of one statement, less its nested statements (they come
    through :func:`_body_statements` on their own) and nested defs."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.stmt, ast.ExceptHandler,
                                  ast.Lambda)):
                continue
            stack.append(child)


def _host_fns(project: Project, module: Module) -> Set[str]:
    """Names the module calls functions by whose return annotation names
    no tensor: its own module-level functions and those it imports by name
    from another module of the project."""
    def host(mod: Module) -> Set[str]:
        return {n.name for n in mod.tree.body
                if isinstance(n, ast.FunctionDef) and _returns_no_tensor(n)}

    out = host(module)
    for node in module.tree.body:
        if isinstance(node, ast.ImportFrom) and not node.level and \
                node.module in project.by_name:
            theirs = host(project.by_name[node.module])
            out |= {a.asname or a.name for a in node.names
                    if a.name in theirs}
    return out


def _hot_flows(project: Project, module: Module):
    """(qualname, def, statement, flow) over every statement of every hot
    function, the flow holding the tensors bound before the statement."""
    fns = hot_functions(module)
    if not fns:
        return
    aliases = _torch_aliases(module)
    host_fns = _host_fns(project, module)
    for qual, fn in fns:
        flow = _TensorFlow(fn, aliases, host_fns)
        for stmt in _body_statements(fn):
            yield qual, fn, stmt, flow
            flow.feed(stmt)


@register_rule
class HostSyncRule:
    """Host reads (.item(), .tolist(), casts, ...) of tensors in hot code."""

    id = "torch-host-sync"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            for qual, _fn, stmt, flow in _hot_flows(project, module):
                for node in _own_nodes(stmt):
                    if not isinstance(node, ast.Call):
                        continue
                    name = call_name(node) or ""
                    method = isinstance(node.func, ast.Attribute) and \
                        node.func.attr in _HOST_METHODS
                    if method:
                        target = node.func.value
                    elif name in _HOST_CASTS and node.args:
                        target = node.args[0]
                    else:
                        continue
                    if not flow.expr(target):
                        continue
                    what = f".{node.func.attr}()" if method else f"{name}()"
                    yield Finding(
                        self.id, self.severity, module.path, node.lineno,
                        symbol=qual,
                        message=(
                            f"{what} of a tensor in hot code waits for the "
                            f"device's queue to drain (a host sync); keep "
                            f"the value on the device, or read it once "
                            f"where the host needs it and say why"))


@register_rule
class TensorBranchRule:
    """Python control flow on a tensor inside a hot function."""

    id = "torch-tensor-branch"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            for qual, _fn, stmt, flow in _hot_flows(project, module):
                tests = []
                if isinstance(stmt, (ast.If, ast.While, ast.Assert)):
                    tests.append(stmt.test)
                tests += [n.test for n in _own_nodes(stmt)
                          if isinstance(n, ast.IfExp)]
                for test in tests:
                    if _is_none_check(test) or not flow.expr(test):
                        continue
                    yield Finding(
                        self.id, self.severity, module.path, test.lineno,
                        symbol=qual,
                        message=(
                            "Python branch on a tensor in hot code reads "
                            "its value on the host (an implicit sync); use "
                            "torch.where, or read it once deliberately"))


# ---------------------------------------------------------------------------
# Launch shapes
# ---------------------------------------------------------------------------


def _annotated_int(arg: ast.arg) -> bool:
    """``int`` or ``Optional[int]`` (any annotation naming ``int``)."""
    return arg.annotation is not None and any(
        isinstance(n, ast.Name) and n.id == "int"
        for n in ast.walk(arg.annotation))


def _int_params(fn: ast.AST) -> List[Tuple[int, str]]:
    """(position or -1 for keyword-only, name) of the ``int``-annotated
    parameters of a def."""
    a = fn.args
    positional = list(a.posonlyargs) + list(a.args)
    return [(i, arg.arg) for i, arg in enumerate(positional)
            if _annotated_int(arg)] + \
        [(-1, arg.arg) for arg in a.kwonlyargs if _annotated_int(arg)]


def _launches(fn: ast.AST) -> bool:
    """True when a def launches a kernel (calls an ALL_CAPS ``Kernel``
    object) or resolves launch params (``tuning.resolve``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if (isinstance(node.func, ast.Name) and name.isupper()) or \
                    name.endswith("tuning.resolve"):
                return True
    return False


def kernel_wrappers(project: Project) -> Dict[str, Dict[str, list]]:
    """{module name: {function: its int parameters}} for the kernel
    wrappers: the public module-level functions of every
    ``kernels/*/ops.py`` that launch a kernel or resolve its launch
    params (helpers such as split plans are not wrappers)."""
    out: Dict[str, Dict[str, list]] = {}
    for module in project.modules:
        if not fnmatch.fnmatchcase(relative_name(module), "kernels.*.ops"):
            continue
        fns = {}
        for node in module.tree.body:
            if isinstance(node, ast.FunctionDef) and \
                    not node.name.startswith("_") and _launches(node):
                params = _int_params(node)
                if params:
                    fns[node.name] = params
        out[module.name] = fns
    return out


def _callee_modules(module: Module, wrappers) -> Dict[str, str]:
    """Local name -> wrapper module name, for names the module binds to a
    kernel ops module (``topk_ops``) or to one of its functions."""
    out: Dict[str, str] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, ast.ImportFrom) and not node.level:
            mod = node.module or ""
            for a in node.names:
                full = f"{mod}.{a.name}"
                if full in wrappers:
                    out[a.asname or a.name] = full
                elif mod in wrappers and a.name in wrappers[mod]:
                    out[a.asname or a.name] = mod
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name in wrappers and a.asname:
                    out[a.asname] = a.name
    if module.name in wrappers:
        for fn in wrappers[module.name]:
            out.setdefault(fn, module.name)
    return out


def _single_assignments(fn: ast.AST) -> Dict[str, ast.AST]:
    """name -> value expr for names assigned exactly once within ``fn``."""
    assigns: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    assigns.setdefault(tgt.id, []).append(node.value)
        elif isinstance(node, ast.AugAssign) and \
                isinstance(node.target, ast.Name):
            assigns.setdefault(node.target.id, []).append(node)
    return {n: vals[0] for n, vals in assigns.items() if len(vals) == 1}


def _bounded(node: ast.AST, env: Dict[str, ast.AST],
             stack: Optional[Set[str]] = None) -> bool:
    """Value set provably finite across the process lifetime. ``env`` maps
    single-assigned local names to their value exprs (resolved
    recursively: ``k = min(user_k, K_MAX)`` makes ``k`` bounded)."""
    stack = stack if stack is not None else set()
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        if node.id.isupper():
            return True
        if node.id in env and node.id not in stack:
            return _bounded(env[node.id], env, stack | {node.id})
        return False
    if isinstance(node, ast.Attribute):
        # shapes/dtypes are the inputs'; ALL_CAPS module constants
        return node.attr in _STATIC_ATTRS or node.attr.isupper()
    if isinstance(node, ast.Subscript):
        return _bounded(node.value, env, stack)
    if isinstance(node, ast.UnaryOp):
        return _bounded(node.operand, env, stack)
    if isinstance(node, ast.BinOp):
        return _bounded(node.left, env, stack) and \
            _bounded(node.right, env, stack)
    if isinstance(node, ast.IfExp):
        return _bounded(node.body, env, stack) and \
            _bounded(node.orelse, env, stack)
    if isinstance(node, ast.Call):
        name = (call_name(node) or "").split(".")[-1]
        if name in ("len", "size", "dim", "numel"):
            return True
        if name == "min":   # a clamp: bounded if ANY bound is bounded
            return any(_bounded(a, env, stack) for a in node.args)
        if name == "max":
            return all(_bounded(a, env, stack) for a in node.args)
        # bucket lookups quantize to the finite kernels/tuning.py ladder
        if "bucket" in name or name in ("size_bucket", "resolve"):
            return True
    return False


@register_rule
class UnboundedLaunchRule:
    """Kernel-wrapper launch parameters from unbounded value sets."""

    id = "torch-unbounded-launch"
    severity = "warning"

    def check(self, project: Project) -> Iterable[Finding]:
        wrappers = kernel_wrappers(project)
        for module in project.modules:
            callees = _callee_modules(module, wrappers)
            for qual, fn, _cls in iter_functions(module.tree):
                env = _single_assignments(fn)
                for node in ast.walk(fn):
                    if isinstance(node, ast.Call):
                        yield from self._site(module, qual, fn, node, env,
                                              wrappers, callees)

    def _site(self, module, qual, fn, node, env, wrappers, callees):
        name = call_name(node) or ""
        head, _, last = name.rpartition(".")
        if last == "resolve" and head.split(".")[-1] == "tuning":
            args = [(kw.arg, kw.value) for kw in node.keywords if kw.arg]
            callee = "tuning.resolve"
        else:
            mod = callees.get(head) if head else callees.get(last)
            params = wrappers.get(mod, {}).get(last) if mod else None
            if not params or (fn.name == last and not head):
                return
            by_pos = {i: p for i, p in params if i >= 0}
            wanted = {p for _i, p in params}
            args = [(by_pos[i], a) for i, a in enumerate(node.args)
                    if i in by_pos]
            args += [(kw.arg, kw.value) for kw in node.keywords
                     if kw.arg in wanted]
            callee = f"{last}()"
        # a wrapper handing its own launch parameter on is checked where
        # it is called
        own = {p for _i, p in _int_params(fn)} if fnmatch.fnmatchcase(
            relative_name(module), "kernels.*.ops") else set()
        for pname, value in args:
            if pname in TUNED_BLOCK_KWARGS or _bounded(value, env) or \
                    (isinstance(value, ast.Name) and value.id in own):
                continue
            yield Finding(
                self.id, self.severity, module.path, node.lineno,
                symbol=qual,
                message=(
                    f"launch parameter {pname!r} of {callee} may take "
                    f"unboundedly many values — each distinct value is a "
                    f"launch shape the serving warm-up never saw "
                    f"(steady_new_shapes); clamp it to a bucket "
                    f"(kernels/tuning.size_bucket) or a min() bound"))


# ---------------------------------------------------------------------------
# In-place writes
# ---------------------------------------------------------------------------


def _basic_index(sl: ast.AST) -> bool:
    """A subscript that is a view: slices, ints, ``None``, ``...``."""
    parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
    return all(isinstance(p, ast.Slice) or
               (isinstance(p, ast.Constant) and
                (p.value is None or p.value is Ellipsis or
                 isinstance(p.value, int)))
               for p in parts)


def _view_source(value: ast.AST) -> Optional[str]:
    """The name ``value`` aliases, when it is a view or alias of one."""
    if isinstance(value, (ast.Name, ast.Attribute)):
        if isinstance(value, ast.Attribute) and value.attr in _VIEW_ATTRS:
            return _view_source(value.value) or dotted_name(value.value)
        return dotted_name(value)
    if isinstance(value, ast.Subscript) and _basic_index(value.slice):
        return _view_source(value.value)
    if isinstance(value, ast.Call) and \
            isinstance(value.func, ast.Attribute) and \
            value.func.attr in _VIEW_METHODS:
        return _view_source(value.func.value)
    return None


def _written(node: ast.AST, flow: Optional[_TensorFlow]) -> List[str]:
    """Names a statement-level node writes in place."""
    out: List[str] = []
    if isinstance(node, ast.Assign):
        for tgt in node.targets:
            if isinstance(tgt, ast.Subscript):
                name = _view_source(tgt.value) or dotted_name(tgt.value)
                if name:
                    out.append(name)
    elif isinstance(node, ast.AugAssign):
        tgt = node.target
        if isinstance(tgt, ast.Subscript):
            name = _view_source(tgt.value) or dotted_name(tgt.value)
            if name:
                out.append(name)
        elif isinstance(tgt, ast.Name) and flow is not None and \
                tgt.id in flow.tensors:
            out.append(tgt.id)
    elif isinstance(node, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr.endswith("_") \
                and not func.attr.startswith("_"):
            name = _view_source(func.value) or dotted_name(func.value)
            if name:
                out.append(name)
        for kw in node.keywords:
            if kw.arg == "out":
                name = _view_source(kw.value) or dotted_name(kw.value)
                if name:
                    out.append(name)
    return out


@register_rule
class InplaceReuseRule:
    """Reads of an alias or view after an in-place write to its tensor."""

    id = "torch-inplace-reuse"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            aliases = _torch_aliases(module)
            host_fns = _host_fns(project, module)
            for qual, fn, _cls in iter_functions(module.tree):
                yield from self._check_function(
                    module, qual, fn, _TensorFlow(fn, aliases, host_fns))

    def _check_function(self, module: Module, qual: str, fn: ast.AST,
                        flow: _TensorFlow) -> Iterable[Finding]:
        # alias name -> (source name, line bound); events in source order
        views: Dict[str, Tuple[str, int]] = {}
        stale: Dict[str, Tuple[str, int]] = {}   # alias -> (base, write)
        reported: Set[str] = set()
        for stmt in _body_statements(fn):
            nodes = list(_own_nodes(stmt))
            # reads of a stale alias in this statement
            for n in nodes:
                ref = dotted_name(n) if isinstance(
                    n, (ast.Name, ast.Attribute)) else None
                if ref in stale and ref not in reported and \
                        isinstance(getattr(n, "ctx", None), ast.Load):
                    base, line = stale[ref]
                    reported.add(ref)
                    yield Finding(
                        self.id, self.severity, module.path, n.lineno,
                        symbol=qual,
                        message=(
                            f"{ref!r} aliases {base!r}, which was written "
                            f"in place on line {line}: the read sees the "
                            f"new values; take a copy (.clone()) before "
                            f"the write, or read {base!r} itself"))
            # in-place writes make every earlier alias of the base stale
            for n in nodes:
                for base in _written(n, flow):
                    for alias, (src, _line) in views.items():
                        if src == base and alias != base:
                            stale[alias] = (base, n.lineno)
            # (re)bindings
            if isinstance(stmt, (ast.Assign, ast.AnnAssign)) and \
                    stmt.value is not None:
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                src = _view_source(stmt.value)
                for tgt in targets:
                    ref = dotted_name(tgt)
                    if ref is None:
                        continue
                    stale.pop(ref, None)
                    views.pop(ref, None)
                    if src is not None and src != ref and \
                            flow.expr(stmt.value):
                        views[ref] = (src, stmt.lineno)
            flow.feed(stmt)


def _slice_start(sub: ast.Subscript) -> Optional[ast.AST]:
    """The leading dimension's slice start of ``x[a:b, ...]`` (a Constant
    0 for an open start), or None when the leading index is no slice."""
    sl = sub.slice
    first = sl.elts[0] if isinstance(sl, ast.Tuple) and sl.elts else sl
    if not isinstance(first, ast.Slice):
        return None
    return first.lower if first.lower is not None else ast.Constant(0)


def _buffer_writes(stmt: ast.stmt) -> List[Tuple[ast.Subscript, int]]:
    """``self.<buf>[a:b] = ...`` and ``self.<buf>[a:b].copy_(...)`` in one
    statement: (the subscript, line)."""
    out = []
    if isinstance(stmt, (ast.Assign, ast.AugAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        for tgt in targets:
            if isinstance(tgt, ast.Subscript) and \
                    _self_attr(tgt.value) is not None and \
                    _slice_start(tgt) is not None:
                out.append((tgt, stmt.lineno))
    for n in _own_nodes(stmt):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "copy_" and \
                isinstance(n.func.value, ast.Subscript) and \
                _self_attr(n.func.value.value) is not None and \
                _slice_start(n.func.value) is not None:
            out.append((n.func.value, n.lineno))
    return out


def _reads_self(node: ast.AST) -> bool:
    return any(_self_attr(n) is not None for n in ast.walk(node))


def _self_store(stmt: ast.stmt) -> bool:
    """True when the statement assigns a ``self.`` attribute."""
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        return any(_self_attr(t) is not None for t in targets)
    return False


@register_rule
class ServeInplaceAppendRule:
    """LiveIndex contract: buffer appends under the lock, past the count."""

    id = "serve-inplace-append"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for module in project.modules:
            if module.package != "serve" and \
                    ".serve." not in f".{module.name}.":
                continue
            for qual, fn, _cls in iter_functions(module.tree):
                yield from self._check_function(module, qual, fn)

    def _problem(self, start: ast.AST, block: Optional[ast.With],
                 line: int) -> Optional[str]:
        if block is None:
            return ("is made outside `with self.<lock>`: a search on "
                    "another thread may be reading those rows")
        if not isinstance(start, ast.Name):
            return ("does not start at a row count read under the lock "
                    "before the update")
        read = None
        for stmt in block.body:
            if stmt.lineno >= line:
                break
            if _self_store(stmt) and read is None:
                return (f"starts at {start.id!r}, which is not read "
                        f"under the lock before the block updates its "
                        f"state")
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == start.id
                    for t in stmt.targets):
                read = stmt
        if read is None or not _reads_self(read.value):
            return (f"starts at {start.id!r}, which is not a row count "
                    f"read under the lock before the write")
        return None

    def _check_function(self, module, qual, fn) -> Iterable[Finding]:
        def walk(stmts, block):
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                inner = block
                if isinstance(s, ast.With) and _with_lock_name(s):
                    inner = s
                for sub, line in _buffer_writes(s):
                    problem = self._problem(_slice_start(sub), block, line)
                    if problem:
                        yield Finding(
                            self.id, self.severity, module.path, line,
                            symbol=qual,
                            message=(
                                f"in-place write into "
                                f"{dotted_name(sub.value)} {problem} — "
                                f"an append writes only rows at or past "
                                f"the count every earlier snapshot holds"))
                for field in ("body", "orelse", "finalbody"):
                    yield from walk(getattr(s, field, None) or (), inner)
                for h in getattr(s, "handlers", None) or ():
                    yield from walk(h.body, inner)

        yield from walk(fn.body, None)
