"""Contract analyzer CLI (port of ``repro/launch/lint.py``; DESIGN.md §15).

  PYTHONPATH=src python -m repro_torch.launch.lint src/repro_torch
  PYTHONPATH=src python -m repro_torch.launch.lint --json src/repro_torch
  PYTHONPATH=src python -m repro_torch.launch.lint --imports
  PYTHONPATH=src python -m repro_torch.launch.lint --write-baseline

Exit codes: 0 clean; 1 when any finding at/above ``--fail-on`` severity
(default: error) is not in the committed baseline; 2 on usage errors.
The baseline (``lint_baseline_torch.json`` at the repo root) holds accepted
finding fingerprints — line-number-free, so unrelated edits don't churn
it. ``--write-baseline`` regenerates it after a reviewed change.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis import core as acore

__all__ = ["main", "run"]

#: rules the --imports mode restricts to (the layering contract)
IMPORT_RULES = ("import-cycle", "import-layering")

DEFAULT_PATHS = ("src/repro_torch",)
DEFAULT_BASELINE = "lint_baseline_torch.json"


def run(paths: List[str], *, rules: Optional[List[str]] = None,
        baseline_path: str = DEFAULT_BASELINE, fail_on: str = "error",
        write_baseline: bool = False) -> dict:
    """Analyze ``paths``; returns the report dict (the --json payload)."""
    acore.load_default_rules()
    project = acore.Project.load(paths)
    findings = acore.analyze(project, rules=rules)
    baseline = acore.load_baseline(baseline_path)
    fresh = acore.new_findings(findings, baseline)
    threshold = acore.SEVERITIES[fail_on]
    # --write-baseline ACCEPTS the current findings, so nothing fails
    failing = [] if write_baseline else \
        [f for f in fresh if acore.SEVERITIES[f.severity] >= threshold]
    counts = {sev: 0 for sev in acore.SEVERITIES}
    for f in findings:
        counts[f.severity] += 1
    if write_baseline:
        acore.save_baseline(baseline_path, findings)
    new_fps = {f.fingerprint for f in fresh}
    return {
        "version": 1,
        "paths": list(paths),
        "rules": list(rules) if rules else list(acore.available_rules()),
        "counts": counts,
        "new": len(fresh),
        "failing": len(failing),
        "fail_on": fail_on,
        "baseline": baseline_path,
        "findings": [dict(f.to_dict(), new=f.fingerprint in new_fps)
                     for f in findings],
    }


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="contract analyzer: host syncs, launch shapes and "
                    "in-place writes, concurrency, registry conformance, "
                    "import hygiene")
    p.add_argument("paths", nargs="*", default=None,
                   help=f"files/dirs to analyze (default: "
                        f"{' '.join(DEFAULT_PATHS)})")
    p.add_argument("--json", action="store_true",
                   help="emit the full JSON report to stdout")
    p.add_argument("--json-out", default=None, metavar="PATH",
                   help="also write the JSON report to PATH (CI artifact)")
    p.add_argument("--rules", default=None, metavar="ID[,ID...]",
                   help="run only these rule ids "
                        "(see --list-rules)")
    p.add_argument("--list-rules", action="store_true",
                   help="print registered rule ids and exit")
    p.add_argument("--imports", action="store_true",
                   help="import hygiene only: package cycles + layering "
                        f"({', '.join(IMPORT_RULES)})")
    p.add_argument("--baseline", default=DEFAULT_BASELINE, metavar="PATH",
                   help="accepted-findings fingerprint file "
                        f"(default: {DEFAULT_BASELINE})")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings as the new baseline")
    p.add_argument("--fail-on", default="error",
                   choices=tuple(acore.SEVERITIES),
                   help="exit 1 on new findings at/above this severity "
                        "(default: error)")
    args = p.parse_args(argv)

    acore.load_default_rules()
    if args.list_rules:
        for rule_id in acore.available_rules():
            rule = acore.get_rule(rule_id)
            print(f"{rule_id:26s} {rule.severity:8s} "
                  f"{(rule.__doc__ or '').strip().splitlines()[0]}")
        return 0

    rules: Optional[List[str]] = None
    if args.imports:
        rules = list(IMPORT_RULES)
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        for r in rules:
            acore.get_rule(r)  # raise early on unknown ids

    paths = args.paths or list(DEFAULT_PATHS)
    try:
        report = run(paths, rules=rules, baseline_path=args.baseline,
                     fail_on=args.fail_on,
                     write_baseline=args.write_baseline)
    except (OSError, ValueError, SyntaxError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    payload = json.dumps(report, indent=2)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(payload + "\n")
    if args.json:
        print(payload)
    else:
        for f_dict in report["findings"]:
            marker = "NEW " if f_dict["new"] else ""
            print(f"{f_dict['path']}:{f_dict['line']}: "
                  f"{f_dict['severity']}: {marker}{f_dict['rule']}: "
                  f"{f_dict['message']}"
                  + (f" [{f_dict['symbol']}]" if f_dict["symbol"] else ""))
        c = report["counts"]
        print(f"{len(report['findings'])} findings "
              f"({c['error']} error, {c['warning']} warning, "
              f"{c['info']} info); {report['new']} not in baseline")
        if args.write_baseline:
            print(f"baseline written: {args.baseline}")
    return 1 if report["failing"] else 0


if __name__ == "__main__":
    sys.exit(main())
