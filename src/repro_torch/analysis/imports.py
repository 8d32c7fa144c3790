"""Import hygiene rules (port of ``repro/analysis/imports.py``; DESIGN.md
§15): package cycles and layering.

  * ``import-cycle`` (error) — a cycle between ``repro_torch.*`` packages
    (or between top-level packages of a fixture tree) at module import
    time. Function-level (deferred) imports that *would* close a cycle are
    a warning: the cycle is latent — invisible until someone hoists the
    import, at which point the failure is an ImportError at a distance.
  * ``import-layering`` (error) — each package has a declared rank
    (:data:`LAYERS`); an import must point strictly *down* the ranks.
    This is what makes "eval importing upward" (serve, launch) a finding
    rather than a review comment.

Both rules look only at module names under the importing module's own
root (fixture trees in tests emulate the port by creating a
``repro_torch/`` package dir), so third-party or stdlib imports never trip
them.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.concurrency_rules import graph_cycle
from repro_torch.analysis.core import Finding, Module, Project, register_rule

__all__ = ["LAYERS", "ImportEdge", "import_edges"]

#: Package ranks: an import must point to a strictly lower rank.
#: device and obs are the foundation (everything resolves a device, traces
#: and counts); launch the roof. Two ranks differ from the reference's:
#: models sits above core, since the port's transformer draws its weights
#: from core/prng.py (the reference's from jax.random) and nothing in core
#: needs a model; and the root modules rank on their own: device at the
#: bottom, interop (the parity tests' conversions of core and retrieval
#: structures) above retrieval.
LAYERS: Dict[str, int] = {
    "device": 0,
    "obs": 0,
    "kernels": 1,
    "distributed": 2,
    "core": 3,
    "models": 4,
    "data": 4,
    "train": 4,
    "retrieval": 5,
    "eval": 6,
    "serve": 6,
    "interop": 6,
    "configs": 7,
    "analysis": 7,
    "launch": 8,
}


@dataclasses.dataclass(frozen=True)
class ImportEdge:
    """One package->package import with its first witnessing statement."""

    src: str            # importing package
    dst: str            # imported package
    path: str
    line: int
    deferred: bool      # inside a function body (imported lazily)


def _target_packages(node: ast.AST, module: Module) -> List[str]:
    """Subpackage names of the module's own root package that a single
    import statement reaches."""
    root = module.name.split(".")[0]
    out: List[str] = []
    if isinstance(node, ast.Import):
        for alias in node.names:
            parts = alias.name.split(".")
            if parts[0] == root and len(parts) > 1:
                out.append(parts[1])
    elif isinstance(node, ast.ImportFrom):
        if node.level:  # relative: resolve against this module's name
            base = module.name.split(".")[:-node.level]
            parts = base + (node.module.split(".") if node.module else [])
        else:
            parts = (node.module or "").split(".")
        if parts and parts[0] == root and len(parts) > 1:
            out.append(parts[1])
    return out


def import_edges(project: Project) -> List[ImportEdge]:
    """Package-level import graph of the project, deduplicated to the
    first witness per (src, dst, deferred)."""
    seen: Dict[Tuple[str, str, bool], ImportEdge] = {}
    for module in project.modules:
        src = module.package
        if not src:
            continue

        def visit(node: ast.AST, deferred: bool):
            for child in ast.iter_child_nodes(node):
                inner = deferred or isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef))
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    for dst in _target_packages(child, module):
                        if dst == src:
                            continue
                        key = (src, dst, deferred)
                        if key not in seen:
                            seen[key] = ImportEdge(
                                src=src, dst=dst, path=module.path,
                                line=child.lineno, deferred=deferred)
                visit(child, inner)

        visit(module.tree, False)
    return sorted(seen.values(),
                  key=lambda e: (e.src, e.dst, e.deferred))


def _graph(edges: Iterable[ImportEdge]) -> Dict[str, Set[str]]:
    g: Dict[str, Set[str]] = {}
    for e in edges:
        g.setdefault(e.src, set()).add(e.dst)
    return g


def _witness(edges: List[ImportEdge], src: str,
             dst: str) -> Optional[ImportEdge]:
    hard = [e for e in edges if e.src == src and e.dst == dst]
    hard.sort(key=lambda e: e.deferred)  # prefer module-level witness
    return hard[0] if hard else None


@register_rule
class ImportCycleRule:
    """Cycles between repro_torch.* packages (latent deferred cycles warn)."""

    id = "import-cycle"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        edges = import_edges(project)
        hard = [e for e in edges if not e.deferred]
        cycle = graph_cycle(_graph(hard))
        if cycle is not None:
            e = _witness(hard, cycle[0], cycle[1])
            yield Finding(
                self.id, "error", e.path if e else "<project>",
                e.line if e else 1, symbol=cycle[0],
                message=("package import cycle: " + " -> ".join(cycle)
                         + " — importing any member fails or silently "
                           "half-initializes depending on entry order"))
            return
        # latent: deferred imports would close a cycle if hoisted
        cycle = graph_cycle(_graph(edges))
        if cycle is not None:
            soft = [e for e in edges if e.deferred
                    and (e.src, e.dst) in zip(cycle, cycle[1:])]
            e = soft[0] if soft else None
            yield Finding(
                self.id, "warning", e.path if e else "<project>",
                e.line if e else 1, symbol=cycle[0],
                message=(
                    "latent package cycle (closed by a function-level "
                    "import): " + " -> ".join(cycle)
                    + " — hoisting the deferred import breaks the build; "
                      "move the shared symbol down the layering instead"))


@register_rule
class ImportLayeringRule:
    """Imports must point strictly down the declared package ranks."""

    id = "import-layering"
    severity = "error"

    def check(self, project: Project) -> Iterable[Finding]:
        for e in import_edges(project):
            src_rank = LAYERS.get(e.src)
            dst_rank = LAYERS.get(e.dst)
            if src_rank is None or dst_rank is None:
                continue  # unranked package (fixtures name their own)
            if dst_rank >= src_rank:
                direction = ("sideways"
                             if dst_rank == src_rank else "upward")
                yield Finding(
                    self.id, self.severity, e.path, e.line, symbol=e.src,
                    message=(
                        f"{e.src} (rank {src_rank}) imports {e.dst} "
                        f"(rank {dst_rank}) — {direction} against the "
                        f"declared layering; move the shared code into a "
                        f"lower-ranked package"
                        + (" (deferred import: still a layering hole)"
                           if e.deferred else "")))
