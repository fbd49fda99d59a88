"""AST lint engine: one parse per file, a rule registry pass, inline
suppressions. A port of ``pipelinedp_tpu/lint/engine.py``.

Each invariant of the port is ONE rule (:mod:`pipelinedp_tpu_torch.lint.
rules`), each source file is parsed ONCE, and every rule visits the
shared tree. Findings are structured (``file:line rule-id message``) and
deliberate exceptions are inline::

    x = time.sleep(1)  # lint: disable=nosleep(reason why this is fine)

Suppressions are data, not invisibility: they are parsed, matched to the
finding they silence, counted and reported. A ``disable`` with no
``(reason)`` never suppresses: it surfaces as a ``lint-suppression``
finding instead, so every silenced invariant carries a written reason.

The engine and its rules are stdlib-only: they parse the files they
check and import none of them.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Pseudo-rule id for malformed suppression comments (a ``disable`` with
#: no written reason, or naming no known rule). Not in the registry: it
#: cannot be disabled.
SUPPRESSION_RULE = "lint-suppression"

#: The package the lint scans, and the script that takes the place of
#: the reference's ``bench.py`` in its scope.
PACKAGE = "pipelinedp_tpu_torch"
HARNESS = "chip_smoke.py"

_SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*disable=([A-Za-z0-9_-]+)\s*(?:\(([^)#]*)\))?")


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    fix_hint: str = ""
    suppressed: bool = False
    reason: str = ""  # the suppression's written reason, when suppressed

    def format(self) -> str:
        tail = f"  [suppressed: {self.reason}]" if self.suppressed else ""
        return f"{self.path}:{self.line} {self.rule} {self.message}{tail}"

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Suppression:
    """One parsed ``# lint: disable=rule(reason)`` comment."""

    rule: str
    path: str
    line: int  # the code line the suppression governs
    comment_line: int  # where the comment physically sits
    reason: str
    used: bool = False

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


class FileContext:
    """One parsed source file, shared by every rule.

    ``rel`` is the repo-relative forward-slash path rules scope on; a
    fixture may lint any source *as if* it lived at any ``rel``, which is
    how path-confined rules are tested without touching the tree.
    """

    def __init__(self, rel: str, source: str):
        self.rel = rel.replace(os.sep, "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=self.rel)
        # line -> {rule_id: Suppression}; a comment-only line's
        # suppression governs the next code line, so a reason may sit on
        # its own line.
        self.suppressions: Dict[int, Dict[str, Suppression]] = {}
        self.bad_suppressions: List[Finding] = []
        self._parse_suppressions()

    def _iter_comment_lines(self):
        """(line_no, comment_text, own_line) for real comments only:
        tokenize, not a regex, so a docstring that shows a suppression
        never registers one."""
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            for tok in tokens:
                if tok.type == tokenize.COMMENT:
                    line_text = self.lines[tok.start[0] - 1]
                    own = line_text.lstrip().startswith("#")
                    yield tok.start[0], tok.string, own
        except tokenize.TokenizeError:  # pragma: no cover
            return

    def _parse_suppressions(self) -> None:
        all_sups: List[Suppression] = []
        for idx, text, own_line in self._iter_comment_lines():
            for m in _SUPPRESS_RE.finditer(text):
                rule, reason = m.group(1), (m.group(2) or "").strip()
                if not reason:
                    self.bad_suppressions.append(Finding(
                        rule=SUPPRESSION_RULE, path=self.rel, line=idx,
                        message=(f"suppression of '{rule}' has no "
                                 "written reason — use "
                                 f"`# lint: disable={rule}(why)`"),
                        fix_hint="every disable must name its why"))
                    continue
                governed = idx
                if own_line:
                    j = idx
                    while j < len(self.lines) and (
                            not self.lines[j].strip()
                            or self.lines[j].lstrip().startswith("#")):
                        j += 1
                    governed = j + 1 if j < len(self.lines) else idx
                all_sups.append(Suppression(
                    rule=rule, path=self.rel, line=governed,
                    comment_line=idx, reason=reason))
        for sup in all_sups:
            self.suppressions.setdefault(sup.line, {})[sup.rule] = sup
        self._all_suppressions = all_sups

    def suppression_for(self, rule: str, line: int
                        ) -> Optional[Suppression]:
        return self.suppressions.get(line, {}).get(rule)

    @property
    def all_suppressions(self) -> List[Suppression]:
        return list(self._all_suppressions)


@dataclasses.dataclass
class LintResult:
    """Everything one lint pass learned about the scanned set."""

    findings: List[Finding] = dataclasses.field(default_factory=list)
    suppressed: List[Finding] = dataclasses.field(default_factory=list)
    suppressions: List[Suppression] = dataclasses.field(
        default_factory=list)
    files_scanned: int = 0
    rules_run: List[str] = dataclasses.field(default_factory=list)
    #: Explicitly requested paths NO rule scopes over (outside the package
    #: and ``chip_smoke.py``): an OK verdict never covers these.
    out_of_scope: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def suppressed_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.suppressed:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def unused_suppressions(self) -> List[Suppression]:
        return [s for s in self.suppressions if not s.used]

    def extend(self, other: "LintResult") -> None:
        self.findings.extend(other.findings)
        self.suppressed.extend(other.suppressed)
        self.suppressions.extend(other.suppressions)
        self.files_scanned += other.files_scanned


def repo_root() -> str:
    """The tree the default scan covers: the repo this package sits in."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def iter_python_files(root: str) -> Iterable[Tuple[str, str]]:
    """Yield ``(abs_path, rel)`` for the scanned set: the port's package
    plus ``chip_smoke.py`` (per-rule scoping narrows further)."""
    targets: List[str] = []
    pkg = os.path.join(root, PACKAGE)
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(files):
            if fname.endswith(".py"):
                targets.append(os.path.join(dirpath, fname))
    harness = os.path.join(root, HARNESS)
    if os.path.exists(harness):
        targets.append(harness)
    for path in sorted(targets):
        yield path, os.path.relpath(path, root).replace(os.sep, "/")


def lint_context(ctx: FileContext, rules: Sequence) -> LintResult:
    """Run ``rules`` over one already parsed file."""
    from pipelinedp_tpu_torch.lint import rules as rules_mod
    result = LintResult(files_scanned=1,
                        rules_run=[r.id for r in rules])
    result.findings.extend(ctx.bad_suppressions)
    run_ids = {r.id for r in rules}
    known_ids = set(rules_mod.rule_ids())
    for sup in ctx.all_suppressions:
        if sup.rule in run_ids:
            result.suppressions.append(sup)
        elif sup.rule not in known_ids:
            result.findings.append(Finding(
                rule=SUPPRESSION_RULE, path=ctx.rel,
                line=sup.comment_line,
                message=(f"suppression names unknown rule "
                         f"'{sup.rule}' — known: "
                         f"{', '.join(sorted(known_ids))}"),
                fix_hint="fix the rule id or delete the comment"))
        # else: the rule exists but is not part of this run; its
        # suppressions are neither counted nor 'unused'.
    for rule in rules:
        if not rule.applies_to(ctx.rel):
            continue
        for line, message in rule.check(ctx):
            finding = Finding(rule=rule.id, path=ctx.rel, line=line,
                              message=message, fix_hint=rule.fix_hint)
            sup = ctx.suppression_for(rule.id, line)
            if sup is not None:
                sup.used = True
                finding.suppressed = True
                finding.reason = sup.reason
                result.suppressed.append(finding)
            else:
                result.findings.append(finding)
    return result


def lint_source(source: str, rel: str,
                rules: Optional[Sequence] = None) -> LintResult:
    """Lint a source string *as if* it lived at ``rel``: the fixture seam.
    Path-confined rules see the virtual location, so a test proves that
    ``nosleep`` fires on a ``time.sleep`` "in" ``streaming.py`` without
    editing the real file."""
    from pipelinedp_tpu_torch.lint import rules as rules_mod
    ctx = FileContext(rel, source)
    return lint_context(ctx, rules if rules is not None
                        else rules_mod.all_rules())


def run(root: Optional[str] = None,
        rule_ids: Optional[Sequence[str]] = None,
        paths: Optional[Sequence[str]] = None) -> LintResult:
    """Lint the tree (or an explicit ``paths`` subset) with the whole
    registry or a ``rule_ids`` subset. One ``ast.parse`` per file."""
    from pipelinedp_tpu_torch.lint import rules as rules_mod
    root = root or repo_root()
    rules = rules_mod.select(rule_ids)
    result = LintResult(rules_run=[r.id for r in rules])
    if paths:
        file_set: List[Tuple[str, str]] = []
        for p in paths:
            ap = p if os.path.isabs(p) else os.path.join(root, p)
            file_set.append((ap, os.path.relpath(ap, root)
                             .replace(os.sep, "/")))
    else:
        file_set = list(iter_python_files(root))
    for path, rel in file_set:
        if paths and not any(r.applies_to(rel) for r in rules):
            # An explicitly requested file every rule scopes out of: "OK"
            # must not read as "checked".
            result.out_of_scope.append(rel)
            continue
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        ctx = FileContext(rel, source)
        result.extend(lint_context(ctx, rules))
    return result
