"""The rule registry: the JAX package's lint rules that carry over to the
port, with the port's paths and names (``kernel-build-confinement`` in the
place of ``nopallas``).

Two reference rules have no counterpart, because they are about JAX:
``jit-staticness`` (nothing ambient read inside a traced body; the port
traces nothing) and ``nofoldin`` (no per-element ``vmap(fold_in)`` key
schedules; the port has no ``vmap``). They are listed in
:data:`NOT_CARRIED` and not registered.

Adding a rule: subclass :class:`~pipelinedp_tpu_torch.lint.rules.base.Rule`
in a module here, list it in :data:`ALL_RULE_CLASSES`, and add a bad and
a clean fixture to ``tests/test_torch_lint.py`` (the registry test fails
until the pair exists).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from pipelinedp_tpu_torch.lint.rules.base import Rule
from pipelinedp_tpu_torch.lint.rules.confinement import (
    CollectiveConfinementRule, FusionMaskingRule, KernelBuildConfinementRule,
    NoArtifactsRule, NoCostRule, NoKnobsRule, NoPerfRule, NoServeRule,
    NoSleepRule, NoStagerRule, SketchConfinementRule, SocketConfinementRule)
from pipelinedp_tpu_torch.lint.rules.locks import BlockingUnderLockRule
from pipelinedp_tpu_torch.lint.rules.rng_purity import RngPurityRule

ALL_RULE_CLASSES = (
    NoSleepRule, NoStagerRule, NoPerfRule, NoArtifactsRule, NoCostRule,
    NoKnobsRule, KernelBuildConfinementRule, NoServeRule, RngPurityRule,
    BlockingUnderLockRule, FusionMaskingRule, SketchConfinementRule,
    SocketConfinementRule, CollectiveConfinementRule)

#: The reference's rules with no counterpart in the port, and why.
NOT_CARRIED = {
    "jit-staticness": "the port traces no program: nothing ambient can "
                      "freeze into one",
    "nofoldin": "the port has no vmap: its key schedules are the "
                "counter-based generator's by construction",
}

_REGISTRY: Dict[str, Rule] = {}
for _cls in ALL_RULE_CLASSES:
    _rule = _cls()
    assert _rule.id and _rule.id not in _REGISTRY, _cls
    _REGISTRY[_rule.id] = _rule


def all_rules() -> List[Rule]:
    return list(_REGISTRY.values())


def rule_ids() -> List[str]:
    return list(_REGISTRY)


def get(rule_id: str) -> Rule:
    try:
        return _REGISTRY[rule_id]
    except KeyError:
        raise KeyError(
            f"unknown lint rule '{rule_id}' — known: "
            f"{', '.join(_REGISTRY)}") from None


def select(rule_ids_seq: Optional[Sequence[str]]) -> List[Rule]:
    if rule_ids_seq is None:
        return all_rules()
    return [get(rid) for rid in rule_ids_seq]


def reference_rules() -> Dict[str, str]:
    """The reference rule each registered rule ports -> its id here."""
    return {r.reference: r.id for r in _REGISTRY.values()
            if r.reference is not None}
