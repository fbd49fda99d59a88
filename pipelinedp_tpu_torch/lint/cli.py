"""``python -m pipelinedp_tpu_torch.lint``: the port's lint entry (a port of
``pipelinedp_tpu/lint/cli.py``).

Exit 0 iff the scanned set has zero unsuppressed findings.  ``--json``
emits one store-shaped document (``{"schema_version", "name", "ts",
"payload"}``, the envelope the port's ``obs/store.py`` appends), so a CI
gate can append it to a run ledger and diff per-rule finding and
suppression counts across runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

from pipelinedp_tpu_torch.lint import engine, rules

#: Store-entry name for the JSON document (ledger-diffable).
RECORD_NAME = "lint.findings"
JSON_SCHEMA_VERSION = 1


def findings_document(result: engine.LintResult,
                      ts: Optional[float] = None) -> Dict[str, Any]:
    """The ``--json`` payload in the run-ledger envelope shape."""
    return {
        "schema_version": JSON_SCHEMA_VERSION,
        "name": RECORD_NAME,
        "ts": time.time() if ts is None else ts,
        "payload": {
            "files_scanned": result.files_scanned,
            "rules_run": sorted(result.rules_run),
            "counts": result.counts(),
            "suppressed_counts": result.suppressed_counts(),
            "findings": [f.to_dict() for f in result.findings],
            "suppressed": [f.to_dict() for f in result.suppressed],
            "suppressions": [s.to_dict()
                             for s in result.suppressions],
            "unused_suppressions": [
                s.to_dict() for s in result.unused_suppressions()],
            "out_of_scope": list(result.out_of_scope),
            "ok": result.ok,
        },
    }


def _print_list() -> None:
    for rule in rules.all_rules():
        origin = (f"(ports {rule.reference})" if rule.reference
                  else "(the port's own)")
        print(f"{rule.id:26s} {origin:32s} {rule.invariant}")
    for rid, why in rules.NOT_CARRIED.items():
        print(f"{rid:26s} {'(not carried over)':32s} {why}")


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m pipelinedp_tpu_torch.lint",
        description="AST invariant checker of the PyTorch package")
    parser.add_argument("--rule", action="append", dest="rule_ids",
                        metavar="ID",
                        help="run only this rule (repeatable)")
    parser.add_argument("--json", action="store_true",
                        help="emit one store-shaped JSON document")
    parser.add_argument("--list", action="store_true",
                        help="list registered rules and exit")
    parser.add_argument("--root", default=None,
                        help="repo root to scan (default: this tree)")
    parser.add_argument("paths", nargs="*",
                        help="explicit files to scan instead of the "
                             "default set (the package + chip_smoke.py)")
    args = parser.parse_args(argv)

    if args.list:
        _print_list()
        return 0

    try:
        result = engine.run(root=args.root, rule_ids=args.rule_ids,
                            paths=args.paths or None)
    except KeyError as e:
        print(str(e), file=sys.stderr)
        return 2

    if args.json:
        print(json.dumps(findings_document(result), indent=2,
                         sort_keys=True))
        return 0 if result.ok else 1

    for f in result.findings:
        print(f.format())
    n_sup = len(result.suppressed)
    if n_sup:
        counts = result.suppressed_counts()
        per_rule = ", ".join(f"{k}={v}"
                             for k, v in sorted(counts.items()))
        print(f"lint: {n_sup} suppressed finding(s) carry written "
              f"reasons ({per_rule})")
    for s in result.unused_suppressions():
        print(f"{s.path}:{s.comment_line} note: unused suppression "
              f"of '{s.rule}' — safe to delete")
    for rel in result.out_of_scope:
        print(f"{rel} warning: outside the scanned scope "
              "(pipelinedp_tpu_torch/ + chip_smoke.py) — NOT checked")
    if result.out_of_scope and not result.files_scanned:
        print("lint: no requested file is in scope — nothing was "
              "checked")
        return 2
    if result.findings:
        print(f"lint: FAILED — {len(result.findings)} unsuppressed "
              f"finding(s) across {result.files_scanned} file(s)")
        return 1
    print(f"lint: OK — {result.files_scanned} file(s), "
          f"{len(result.rules_run)} rule(s), {n_sup} suppression(s)")
    return 0
