"""Rule base class and the small AST vocabulary every rule shares."""

from __future__ import annotations

import ast
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

#: (line, message) pairs; the engine wraps them into Findings.
RuleHits = Iterable[Tuple[int, str]]

#: Path prefix of the scanned package, and the scanned script that stands
#: where the reference's ``bench.py`` stands.
PKG = "pipelinedp_tpu_torch/"
HARNESS = "chip_smoke.py"


class Rule:
    """One invariant: an id, the prose of what it protects, a fix hint,
    and a ``check`` over a parsed file.

    ``reference`` names the rule of the JAX package's lint that this one
    ports (None for a rule of the port's own); the registry test holds
    the carried-over set to the reference's.
    """

    id: str = ""
    reference: Optional[str] = None
    invariant: str = ""
    fix_hint: str = ""
    #: Path prefixes (or exact files) this rule never scans: the blessed
    #: modules. ``applies_to`` consults it.
    blessed: Sequence[str] = ()
    #: Whether the rule scans ``chip_smoke.py`` beside the package.
    scans_bench: bool = True

    def applies_to(self, rel: str) -> bool:
        if rel == HARNESS:
            return self.scans_bench
        if not rel.startswith(PKG):
            return False
        return not any(
            rel == b or rel.startswith(b) for b in self.blessed)

    def check(self, ctx) -> RuleHits:
        raise NotImplementedError


def in_paths(rel: str, paths: Sequence[str]) -> bool:
    """``rel`` is one of ``paths`` or lies under one of them."""
    return any(rel == p or rel.startswith(p) for p in paths)


def terminal_name(node: ast.AST) -> Optional[str]:
    """The rightmost identifier of a Name/Attribute chain
    (``a.b.c`` -> ``c``; ``f`` -> ``f``)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a pure Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def receiver_terminal(node: ast.AST) -> Optional[str]:
    """For ``x.y.attr`` the terminal name of the receiver ``x.y``."""
    if isinstance(node, ast.Attribute):
        return terminal_name(node.value)
    return None


def import_bindings(node: ast.AST) -> List[str]:
    """The dotted module/member names an import statement binds."""
    names: List[str] = []
    if isinstance(node, ast.ImportFrom) and node.module:
        names.append(node.module)
        names.extend(f"{node.module}.{a.name}" for a in node.names)
    elif isinstance(node, ast.Import):
        names.extend(a.name for a in node.names)
    return names


def walk_with_function(tree: ast.AST
                       ) -> Iterator[Tuple[ast.AST, str]]:
    """Yield ``(node, enclosing_function_name)`` pairs; ``<module>`` at
    top level. A nested function reports its own name."""

    def visit(node: ast.AST, func: str):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        yield node, func
        for child in ast.iter_child_nodes(node):
            yield from visit(child, func)

    yield from visit(tree, "<module>")


def walk_with_qualname(tree: ast.AST) -> Iterator[Tuple[ast.AST, str]]:
    """Yield ``(node, qualified_function_name)`` pairs: the enclosing
    functions joined by dots (``_stream_impl.launch`` for a closure inside
    ``_stream_impl``), ``<module>`` at top level."""

    def visit(node: ast.AST, qual: str):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = (node.name if qual == "<module>"
                    else f"{qual}.{node.name}")
        yield node, qual
        for child in ast.iter_child_nodes(node):
            yield from visit(child, qual)

    yield from visit(tree, "<module>")
