"""Lock discipline: no blocking work inside a held lock body (a port of
``pipelinedp_tpu/lint/rules/locks.py``).

The exact bug class every serve review pass fixed by hand: a durable
(fsync'd) ledger write, a queue wait, or a second lock acquisition
inside ``with self._lock:`` turns one tenant's disk sync into every
other tenant's admission stall — or a lock-ordering deadlock.  The
admission path was rewritten so the fsync'd reserve runs OUTSIDE the
global lock; this rule makes that shape regression-proof.

Intra-procedural on purpose: a helper that fsyncs may legitimately be
*called* under a per-tenant lock (the budget ledger's exactly-once
discipline REQUIRES write-under-tenant-lock); what the rule polices is
the syntactic shape — blocking primitives directly inside a ``with
<lock>:`` body — which is where every real instance of the bug lived.
Deliberate holds are blessed inline with a written reason.
"""

from __future__ import annotations

import ast

from pipelinedp_tpu_torch.lint.rules.base import (Rule, receiver_terminal,
                                                  terminal_name)

#: Constructors whose result is lock-like.
_LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition", "Semaphore",
                             "BoundedSemaphore"})

#: Call terminals that block (or do durable IO) on their own.
_BLOCKING_CALLS = frozenset({"fsync", "atomic_write_json", "acquire"})

#: Constructions that open durable stores (directory scans + fsync'd
#: appends) — never inside a held lock.
_STORE_CONSTRUCTORS = frozenset({"LedgerStore", "TenantBudgetLedger",
                                 "CheckpointStore"})

#: Queue-wait attrs, flagged only on queue-shaped receivers.
_QUEUE_WAITS = frozenset({"get", "put", "join"})


def _is_queueish(name):
    if name is None:
        return False
    low = name.lower().lstrip("_")
    return low in ("q", "queue") or "queue" in low


class _LockNames(ast.NodeVisitor):
    """Collect names that hold locks: assigned from a lock factory, or
    simply named like one (``*lock*``)."""

    def __init__(self):
        self.names = set()

    def visit_Assign(self, node):
        val = node.value
        if (isinstance(val, ast.Call)
                and terminal_name(val.func) in _LOCK_FACTORIES):
            for tgt in node.targets:
                name = terminal_name(tgt)
                if name:
                    self.names.add(name)
        self.generic_visit(node)


def _lockish(expr, lock_names):
    """Is this with-item expression a lock (or a lock-returning
    call, e.g. ``self._tenant_lock(t)``)?"""
    if isinstance(expr, ast.Call):
        expr = expr.func
    name = terminal_name(expr)
    if name is None:
        return False
    return name in lock_names or "lock" in name.lower()


class BlockingUnderLockRule(Rule):
    id = "blocking-under-lock"
    reference = "blocking-under-lock"
    invariant = ("a held lock body never fsyncs, waits on a queue, "
                 "acquires another lock, or constructs a durable "
                 "store — one tenant's disk sync must not serialize "
                 "every other tenant's admission, and nested "
                 "acquisitions are deadlock bait")
    fix_hint = ("move the blocking work outside the with-block "
                "(reserve/commit OUTSIDE the admission lock, like "
                "serve.service does), or bless the hold with "
                "# lint: disable=blocking-under-lock(reason)")

    def check(self, ctx):
        collector = _LockNames()
        collector.visit(ctx.tree)
        lock_names = collector.names
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            if not any(_lockish(item.context_expr, lock_names)
                       for item in node.items):
                continue
            yield from self._scan_body(node, lock_names)

    def _scan_body(self, with_node, lock_names):
        def is_lock_region(n):
            return (isinstance(n, (ast.With, ast.AsyncWith))
                    and any(_lockish(i.context_expr, lock_names)
                            for i in n.items))

        def walk(node):
            for child in ast.iter_child_nodes(node):
                # Deferred bodies run later, outside the hold.
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                yield child
                # A nested lock region is flagged here but scanned as
                # its own region by check() — don't double-visit it.
                if is_lock_region(child):
                    continue
                yield from walk(child)

        for stmt in with_node.body:
            if is_lock_region(stmt):
                # Flag the acquisition ONCE; the inner body is scanned
                # by check()'s own iteration over With nodes.
                yield (stmt.lineno, "nested lock acquisition while "
                       "holding a lock")
                continue
            nodes = [stmt] + list(walk(stmt))
            for node in nodes:
                if is_lock_region(node):
                    yield (node.lineno,
                           "nested lock acquisition while "
                           "holding a lock")
                if not isinstance(node, ast.Call):
                    continue
                term = terminal_name(node.func)
                if term in _BLOCKING_CALLS:
                    yield (node.lineno,
                           f"{term}() inside a held lock body")
                elif term in _STORE_CONSTRUCTORS:
                    yield (node.lineno,
                           f"{term} construction inside a held lock "
                           "body")
                elif (term in _QUEUE_WAITS
                      and _is_queueish(
                          receiver_terminal(node.func))):
                    yield (node.lineno,
                           f"queue .{term}() wait inside a held lock "
                           "body")
