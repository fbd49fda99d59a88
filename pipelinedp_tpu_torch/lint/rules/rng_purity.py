"""DP-purity of randomness: every noise bit is a pure function of
(seed, content). A port of ``pipelinedp_tpu/lint/rules/rng_purity.py``.

Checkpoint resume, serve warm reuse and every bit-for-bit test against
the JAX package assume that noise keys derive from the run seed and the
data, and that host draws come from the seeded host generator in the
reference's order. An unkeyed ``np.random`` draw, a stray
``random.random()`` or a ``torch.rand`` anywhere in the release path
voids bit-identical replay and the DP guarantee (unseeded noise cannot
be audited). This rule confines randomness to the blessed generator
modules; every other site is a violation to fix or a seeded entry seam
to bless inline with a written reason: the suppression inventory IS the
port's rng audit.

What counts as drawing or keying randomness in the port:

* ``prng``'s key operations and draws (the threefry streams that
  reproduce JAX's: ``PRNGKey``, ``split``, ``fold_in``, ``bits``,
  ``uniform``, ``laplace``, ``normal``), any ``fold_in``, and
  ``counter_rng``'s draws;
* a reach into the host generator of ``ops/noise.py`` (``_host_rng``),
  which only that module's samplers and seeding should touch;
* ``np.random`` / ``numpy.random`` and stdlib ``random`` calls, torch's
  draws (``torch.rand``, ``torch.randn``, ``torch.randint``, ...) and a
  tensor's in-place draws (``.uniform_()``, ``.normal_()``, ...);
* from-imports that hide any of these behind bare names.

``chip_smoke.py`` is out of scope: it owns seeded synthetic *data*
generation, which is workload, not DP noise.
"""

from __future__ import annotations

import ast

from pipelinedp_tpu_torch.lint.rules.base import (PKG, Rule, dotted_name,
                                                  terminal_name)

#: Modules allowed to draw randomness: the threefry streams, the
#: counter-based node-noise generator, the host noise ops and the batched
#: vector-noise seam.
BLESSED_MODULES = (PKG + "ops/prng.py", PKG + "ops/counter_rng.py",
                   PKG + "ops/noise.py", PKG + "ops/vector_noise.py")

_PRNG_MEMBERS = frozenset({"PRNGKey", "split", "fold_in", "bits",
                           "uniform", "laplace", "normal", "threefry2x32"})
_COUNTER_MEMBERS = frozenset({"row_bits", "laplace", "normal"})
_TORCH_DRAWS = frozenset({"rand", "rand_like", "randn", "randn_like",
                          "randint", "randint_like", "randperm", "normal",
                          "bernoulli", "multinomial", "poisson",
                          "manual_seed", "seed", "Generator"})
_INPLACE_DRAWS = frozenset({"uniform_", "normal_", "exponential_",
                            "bernoulli_", "random_", "geometric_",
                            "cauchy_", "log_normal_"})

#: from-imports that hide rng call sites behind bare names: a module of
#: draws, or the draw members of the generator modules.
_RNG_FROM_MODULES = frozenset({"random", "numpy.random", "torch.random"})
_FROM_MEMBERS = {PKG.rstrip("/") + ".ops.prng": _PRNG_MEMBERS,
                 PKG.rstrip("/") + ".ops.counter_rng": _COUNTER_MEMBERS}


class RngPurityRule(Rule):
    id = "rng-purity"
    reference = "rng-purity"
    invariant = ("noise keys are pure functions of (seed, content): "
                 "randomness is drawn only in ops/prng.py, "
                 "ops/counter_rng.py, ops/noise.py and ops/vector_noise.py; "
                 "every other site is a blessed seeded seam with a "
                 "written reason, or a bug")
    fix_hint = ("derive keys via ops.prng / ops.counter_rng, sample via "
                "ops.noise, or bless the seeded seam with "
                "# lint: disable=rng-purity(reason)")
    blessed = BLESSED_MODULES
    scans_bench = False

    def check(self, ctx):
        hits = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                members = _FROM_MEMBERS.get(mod, frozenset())
                if mod in _RNG_FROM_MODULES or any(
                        a.name in members for a in node.names):
                    hits.setdefault(
                        node.lineno, f"from-import of {mod} members hides "
                        "rng call sites behind bare names")
                continue
            if (isinstance(node, ast.Attribute)
                    and node.attr == "_host_rng"):
                hits.setdefault(node.lineno,
                                "reach into ops.noise's host generator")
                continue
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            dotted = dotted_name(fn) or ""
            term = terminal_name(fn)
            recv = dotted.rsplit(".", 1)[0] if "." in dotted else ""
            last = recv.rsplit(".", 1)[-1]
            if term == "fold_in":
                msg = "fold_in key derivation"
            elif last == "prng" and term in _PRNG_MEMBERS:
                msg = f"threefry key or draw: {dotted}"
            elif last == "counter_rng" and term in _COUNTER_MEMBERS:
                msg = f"counter-based draw: {dotted}"
            elif dotted.startswith(("np.random.", "numpy.random.")):
                msg = f"numpy rng call: {dotted}"
            elif recv == "random":
                msg = f"stdlib random call: {dotted}"
            elif (recv in ("torch", "torch.random")
                  and term in _TORCH_DRAWS) or recv == "torch.random":
                msg = f"torch rng call: {dotted}"
            elif (isinstance(fn, ast.Attribute)
                  and fn.attr in _INPLACE_DRAWS):
                msg = f"in-place tensor draw: .{fn.attr}()"
            else:
                continue
            hits.setdefault(node.lineno, msg + " outside the blessed "
                            "generator modules")
        for line in sorted(hits):
            yield (line, hits[line])
