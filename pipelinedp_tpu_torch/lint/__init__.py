"""The port's AST invariant checker: one engine, a rule registry over a
single parse per file, structured findings and counted inline
suppressions. A port of the JAX package's ``pipelinedp_tpu/lint/``; it
scans ``pipelinedp_tpu_torch/`` and ``chip_smoke.py``.

The reference's ``jit-staticness`` and ``nofoldin`` rules have no
counterpart (they are about JAX's tracing and ``vmap``;
``rules.NOT_CARRIED`` says why); ``kernel-build-confinement`` takes the
place of ``nopallas``.

CLI::

    python -m pipelinedp_tpu_torch.lint [--rule ID ...] [--json] [--list]

Test seam: :func:`check_tree` (the formatted unsuppressed findings) and
:func:`~pipelinedp_tpu_torch.lint.engine.lint_source` (lint a source
string as if it lived at a given path, for rule fixtures).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from pipelinedp_tpu_torch.lint import rules
from pipelinedp_tpu_torch.lint.engine import (Finding, LintResult,
                                              Suppression, lint_source,
                                              repo_root, run)

__all__ = ["Finding", "LintResult", "Suppression", "check_tree",
           "lint_source", "repo_root", "rules", "run"]


def check_tree(*rule_ids: str, root: Optional[str] = None,
               paths: Optional[Sequence[str]] = None) -> List[str]:
    """Run rules over the tree (or ``paths`` of it); return the formatted
    UNSUPPRESSED findings (empty: the invariant holds)."""
    ids: Optional[Sequence[str]] = list(rule_ids) or None
    result = run(root=root, rule_ids=ids, paths=paths)
    return [f.format() for f in result.findings]
