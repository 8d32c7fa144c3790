"""AST-based contract analyzer (port of ``repro/analysis``; DESIGN.md §15).

Machine-checks the invariants the port's runtime layers rely on: host
syncs and launch-shape hazards in hot code, in-place write safety, lock
discipline across the serving tier, and registry-protocol conformance.
Run it with::

    PYTHONPATH=src python -m repro_torch.launch.lint src/repro_torch
    PYTHONPATH=src python -m repro_torch.launch.lint --imports
"""
from repro_torch.analysis.core import (Finding, LintRule, Module, Project,
                                       analyze, available_rules, get_rule,
                                       load_baseline, load_default_rules,
                                       new_findings, register_rule,
                                       save_baseline)

__all__ = ["Finding", "LintRule", "Module", "Project", "analyze",
           "available_rules", "get_rule", "load_baseline",
           "load_default_rules", "new_findings", "register_rule",
           "save_baseline"]
