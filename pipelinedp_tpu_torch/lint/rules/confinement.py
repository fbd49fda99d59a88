"""The confinement rules: each keeps one kind of call, import or name in
the modules that own it. Ported from the JAX package's lint
(``pipelinedp_tpu/lint/rules/confinement.py``) with the port's paths and
the port's names for the same things: CUDA events and the allocator's
counters for XLA's cost analysis, ``torch.distributed`` collectives for
``jax.lax``'s, and the ``nvcc`` build of ``ops/kernels/`` for Pallas.

Each rule keeps the reference rule's id (``kernel-build-confinement``
replaces ``nopallas``). Strings and docstrings may name the banned things
freely, aliases (``_time.sleep``) are still caught, and the stager rule's
"at most N sites, only in these functions" shape holds wherever the
engine runs.
"""

from __future__ import annotations

import ast

from pipelinedp_tpu_torch.lint.rules.base import (HARNESS, PKG, Rule,
                                                  dotted_name,
                                                  import_bindings, in_paths,
                                                  receiver_terminal,
                                                  terminal_name,
                                                  walk_with_function,
                                                  walk_with_qualname)


class NoSleepRule(Rule):
    """No direct ``time.sleep`` and no bare ``threading.Thread``."""

    id = "nosleep"
    reference = "nosleep"
    invariant = ("waits route through the injectable resilience clock; "
                 "worker threads through the ingest executor's "
                 "cancellable lifecycle (fault kills must drain to "
                 "zero orphan pdp-* threads)")
    fix_hint = ("use pipelinedp_tpu_torch.resilience.clock for sleeps and "
                "the ingest executor's _CaptureThread for threads")
    _SLEEP_EXEMPT = (PKG + "resilience/clock.py",)
    #: The port starts its worker threads only through the ingest
    #: executor (the JAX package also exempts resilience/; the port's
    #: resilience plane starts none).
    _THREAD_EXEMPT = (PKG + "ingest/",)

    def check(self, ctx):
        sleep_ok = in_paths(ctx.rel, self._SLEEP_EXEMPT)
        thread_ok = in_paths(ctx.rel, self._THREAD_EXEMPT)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                fn = node.func
                recv = receiver_terminal(fn)
                if (not sleep_ok and terminal_name(fn) == "sleep"
                        and recv is not None
                        and recv.endswith("time")):
                    yield (node.lineno,
                           "direct time.sleep — waits must route "
                           "through resilience.clock")
                if (not thread_ok
                        and terminal_name(fn) == "Thread"
                        and recv == "threading"):
                    yield (node.lineno,
                           "bare threading.Thread — worker threads "
                           "must use the ingest executor")
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                names = {a.name for a in node.names}
                if not sleep_ok and mod == "time" and "sleep" in names:
                    yield (node.lineno,
                           "from-import of time.sleep — waits must "
                           "route through resilience.clock")
                if (not thread_ok and mod == "threading"
                        and "Thread" in names):
                    yield (node.lineno,
                           "from-import of threading.Thread — worker "
                           "threads must use the ingest executor")


class NoStagerRule(Rule):
    """``BackgroundStager`` construction is confined, and the two consumer
    modules keep exactly their blessed sites."""

    id = "nostager"
    reference = "nostager"
    invariant = ("pass A's overlapped loop and pass B's restreaming flow "
                 "through their one stream source each (and the sketch "
                 "phase through its one accumulation loop); a stray "
                 "stager reintroduces per-tile restreaming and a thread "
                 "lifecycle the kill drains cannot see")
    fix_hint = ("stream through streaming._stream_impl / _pass_b's "
                "run_sweep / sketch.engine._accumulate_stream or the "
                "ingest package; do not construct BackgroundStager "
                "directly")
    blessed = (PKG + "ingest/",)
    #: consumer module -> (allowed enclosing functions, as the qualified
    #: names the walk reports, max sites, prose).
    _CONSUMERS = {
        PKG + "streaming.py": (
            frozenset({"_stream_impl", "_pass_b.run_sweep"}), 2,
            "pass A's overlapped loop (in _stream_impl) and pass B's "
            "run_sweep (nested in _pass_b)"),
        PKG + "sketch/engine.py": (
            frozenset({"_accumulate_stream"}), 1,
            "the sketch accumulation loop"),
    }

    def check(self, ctx):
        sites = []
        for node, func in walk_with_qualname(ctx.tree):
            if (isinstance(node, ast.Call)
                    and terminal_name(node.func) == "BackgroundStager"):
                sites.append((node.lineno, func))
        consumer = self._CONSUMERS.get(ctx.rel)
        if consumer is None:
            for line, _ in sites:
                yield (line, "direct BackgroundStager construction "
                       "outside ingest/ and the blessed consumers")
            return
        allowed, max_sites, prose = consumer
        for line, func in sites:
            if func not in allowed:
                yield (line,
                       f"BackgroundStager site in '{func}' — only "
                       f"{prose} may build stagers here")
        if len(sites) > max_sites:
            for line, _ in sites[max_sites:]:
                yield (line,
                       f"{len(sites)} stager sites in {ctx.rel} "
                       f"(max {max_sites}: {prose})")


class NoPerfRule(Rule):
    """No raw ``perf_counter`` outside obs/, and ``obs/monitor.py`` never
    touches the ``time`` module at all."""

    id = "noperf"
    reference = "noperf"
    invariant = ("measured phases flow through obs spans so they land "
                 "in the run ledger; the watchdog's deadlines ride the "
                 "injectable clock, so monitor.py gets the stricter "
                 "no-time-module check")
    fix_hint = ("time through pipelinedp_tpu_torch.obs spans; in "
                "obs/monitor.py use the injectable resilience clock")
    #: ``chip_smoke.py`` is the card's measuring script: its own timings
    #: are its output, printed beside the card's name.
    scans_bench = False
    _MONITOR = PKG + "obs/monitor.py"

    def check(self, ctx):
        in_obs = ctx.rel.startswith(PKG + "obs/")
        is_monitor = ctx.rel == self._MONITOR
        if in_obs and not is_monitor:
            return
        for node in ast.walk(ctx.tree):
            # A reference (``t = time.perf_counter``) times as well as a
            # call does, and an import binds the name for a bare call.
            if ((isinstance(node, ast.Attribute)
                 and node.attr == "perf_counter")
                    or (isinstance(node, ast.alias)
                        and node.name == "perf_counter")):
                yield (node.lineno,
                       "raw perf_counter timing — route through obs "
                       "spans" if not is_monitor else
                       "raw perf_counter in the monitor — use the "
                       "injectable clock")
            if not is_monitor:
                continue
            # monitor.py: ANY use of the time module is a finding
            # (time.monotonic would dodge a perf_counter-only check).
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mod = getattr(node, "module", "") or ""
                names = [a.name for a in node.names]
                if mod == "time" or "time" in names:
                    yield (node.lineno,
                           "obs/monitor.py imports time — all timing "
                           "must ride the injectable clock")
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Name)
                  and node.value.id in ("time", "_time")
                  and node.attr != "perf_counter"):
                yield (node.lineno,
                       f"obs/monitor.py touches time.{node.attr} — "
                       "all timing must ride the injectable clock")


class NoArtifactsRule(Rule):
    """No ad-hoc ``json.dump`` file writes outside obs/ and plan/."""

    id = "noartifacts"
    reference = "noartifacts"
    invariant = ("run knowledge lands in the schema-versioned "
                 "report/store/plan, never scattered one-off JSON "
                 "files (chip_smoke.py is the one blessed artifact "
                 "emitter)")
    fix_hint = ("route through pipelinedp_tpu_torch.obs (report/store) "
                "or pipelinedp_tpu_torch.plan (the atomic plan file)")
    blessed = (PKG + "obs/", PKG + "plan/")
    scans_bench = False  # chip_smoke.py is the blessed emitter

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "dump"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "json"):
                yield (node.lineno, "ad-hoc json.dump artifact write")


class NoCostRule(Rule):
    """CUDA-event timing and device-memory probes confined to obs/."""

    id = "nocost"
    reference = "nocost"
    invariant = ("CUDA-event timing (elapsed_time) and the allocator's "
                 "peak and live counters flow through the cost table "
                 "(obs/costs.py), so every measurement lands in the "
                 "versioned run report and no module resets the "
                 "process's peak under another's reading")
    fix_hint = ("use pipelinedp_tpu_torch.obs.costs (instrumented phases, "
                "sample_live_bytes)")
    blessed = (PKG + "obs/",)
    #: ``chip_smoke.py`` times each kernel with CUDA events: that is its
    #: measurement, printed beside the card's name.
    scans_bench = False
    _BANNED = frozenset({"elapsed_time", "max_memory_allocated",
                         "reset_peak_memory_stats", "memory_allocated"})

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._BANNED):
                yield (node.lineno,
                       f"direct {node.func.attr}() call")


class NoKnobsRule(Rule):
    """Registered knobs are read only through the plan registry: their
    module constants (the seams) and their environment variables."""

    id = "noknobs"
    reference = "noknobs"
    invariant = ("every knob consumer resolves through plan.knobs "
                 "(env > seam > plan file > default) so a plan can steer "
                 "the value and the resolution lands in the run report's "
                 "plan section; no module of the package names a knob's "
                 "variable (a read needs the name)")
    fix_hint = ("resolve through pipelinedp_tpu_torch.plan (knobs.value / "
                "resolve / seam_override; knobs.BY_NAME[...].env_var for "
                "the variable's name)")
    #: The registry, and the lint's own rule module, which names the
    #: variables to find them.
    blessed = (PKG + "plan/knobs.py", PKG + "lint/rules/confinement.py")
    #: knob constant -> its defining module, where a Store is the seam.
    DEFINING = {"_SUBHIST_BYTE_CAP": PKG + "torch_engine.py",
                "_VECTOR_ACCUMULATOR": PKG + "torch_engine.py",
                "_SELECT_UNITS_CAP": PKG + "streaming.py",
                "_TREE_ROWS_CAP": PKG + "streaming.py",
                "_Q_CHUNK": PKG + "streaming.py",
                "_SWEEP_CONFIG_BATCH": PKG + "analysis/torch_sweep.py",
                "_MESH_TOPOLOGY": PKG + "parallel/sharded.py"}
    KNOB_CONSTANTS = frozenset(DEFINING)
    #: The registry's environment variables (plan/knobs.py REGISTRY; the
    #: lint parses no module it checks, and the plan tests hold this set
    #: to the registry).
    KNOB_ENV_VARS = frozenset({
        "PIPELINEDP_TPU_SUBHIST_CAP", "PIPELINEDP_TPU_STREAM_CHUNK",
        "PIPELINEDP_TPU_STREAM_CACHE", "PIPELINEDP_TPU_INGEST_EXECUTOR",
        "PIPELINEDP_TPU_Q_CHUNK", "PIPELINEDP_TPU_SWEEP_CONFIG_BATCH",
        "PIPELINEDP_TPU_VECTOR_ACCUMULATOR", "PIPELINEDP_TPU_SERVE_FUSION",
        "PIPELINEDP_TPU_SERVE_FUSE_WINDOW_MS",
        "PIPELINEDP_TPU_SERVE_FUSE_BATCH",
        "PIPELINEDP_TPU_SERVE_FUSE_ROWS_FLOOR",
        "PIPELINEDP_TPU_SKETCH_WIDTH", "PIPELINEDP_TPU_SKETCH_DEPTH",
        "PIPELINEDP_TPU_SKETCH_CANDIDATE_CAP",
        "PIPELINEDP_TPU_SKETCH_BACKEND", "PIPELINEDP_TPU_MESH_TOPOLOGY"})

    def check(self, ctx):
        # chip_smoke.py sets knob variables as a user does; the package
        # never names them.
        env_scope = ctx.rel != HARNESS
        for node in ast.walk(ctx.tree):
            if (env_scope and isinstance(node, ast.Constant)
                    and node.value in self.KNOB_ENV_VARS):
                yield (node.lineno,
                       f"knob variable named outside plan/: {node.value}")
                continue
            name = ctxk = None
            if (isinstance(node, ast.Name)
                    and node.id in self.KNOB_CONSTANTS):
                name, ctxk = node.id, node.ctx
            elif (isinstance(node, ast.Attribute)
                  and node.attr in self.KNOB_CONSTANTS):
                name, ctxk = node.attr, node.ctx
            if name is None:
                continue
            if (isinstance(ctxk, ast.Store)
                    and ctx.rel == self.DEFINING.get(name)):
                continue  # the definition IS the seam
            yield (node.lineno, f"direct knob-constant access: {name}")


class KernelBuildConfinementRule(Rule):
    """The ``nvcc`` build of the hand kernels and the ``ctypes`` loads of
    their libraries are reached only from ``ops/kernels/``."""

    id = "kernel-build-confinement"
    reference = "nopallas"
    invariant = ("every module reaches a hand kernel through its wrapper "
                 "in ops/kernels/ (the plain version on a CPU tensor, the "
                 "kernel on a CUDA one, the launch counted), so the build "
                 "cache, the launch counts and the no-fallback rule stay "
                 "in ONE place; native/ builds and loads its own host "
                 "libraries")
    fix_hint = ("call the kernel's wrapper in "
                "pipelinedp_tpu_torch.ops.kernels (segsum, hist, "
                "segtotal, segkeyed)")
    blessed = (PKG + "ops/kernels/",)
    _BUILD = PKG.rstrip("/") + ".ops.kernels._build"
    _CTYPES_OK = (PKG + "native/",)

    def check(self, ctx):
        ctypes_ok = in_paths(ctx.rel, self._CTYPES_OK)
        hits = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                for name in import_bindings(node):
                    if name == self._BUILD:
                        hits.setdefault(node.lineno,
                                        "kernel build module import "
                                        "outside ops/kernels/")
                    elif name == "ctypes" and not ctypes_ok:
                        hits.setdefault(node.lineno,
                                        "ctypes import outside "
                                        "ops/kernels/ and native/")
            elif isinstance(node, ast.Attribute):
                recv = dotted_name(node.value) or ""
                if recv == "_build" or recv.endswith("kernels._build"):
                    hits.setdefault(node.lineno,
                                    f"kernel build access ({recv}."
                                    f"{node.attr}) outside ops/kernels/")
            elif (isinstance(node, ast.Call) and not ctypes_ok
                  and terminal_name(node.func) in ("CDLL", "LoadLibrary")):
                hits.setdefault(node.lineno,
                                "shared-library load outside "
                                "ops/kernels/ and native/")
        for line in sorted(hits):
            yield (line, hits[line])


class NoServeRule(Rule):
    """The service depends on the engine, never the reverse; durable
    budget-ledger state has ONE writer stack."""

    id = "noserve"
    reference = "noserve"
    invariant = ("batch mode stays oblivious to serving (no serve "
                 "imports outside serve/), and TenantBudgetLedger "
                 "construction is confined to serve/ + "
                 "budget_accounting.py so budget debits have one "
                 "durable writer stack")
    fix_hint = ("route budget debits through the serve layer's durable "
                "ledger; never import pipelinedp_tpu_torch.serve from "
                "engine modules")
    blessed = (PKG + "serve/",)
    _LEDGER_EXTRA_BLESSED = (PKG + "budget_accounting.py",)
    _SERVE = PKG.rstrip("/") + ".serve"

    def check(self, ctx):
        ledger_ok = ctx.rel in self._LEDGER_EXTRA_BLESSED
        for node in ast.walk(ctx.tree):
            if (isinstance(node, (ast.Import, ast.ImportFrom))
                    and ctx.rel != HARNESS):
                if any(n == self._SERVE
                       or n.startswith(self._SERVE + ".")
                       for n in import_bindings(node)):
                    yield (node.lineno,
                           "serve import in a batch-engine module — "
                           "the service depends on the engine, never "
                           "the reverse")
            if (not ledger_ok and isinstance(node, ast.Call)
                    and terminal_name(node.func)
                    == "TenantBudgetLedger"):
                yield (node.lineno,
                       "TenantBudgetLedger construction outside "
                       "serve/ + budget_accounting.py")


class FusionMaskingRule(Rule):
    """Fused-batch request preparation and the batched device path's
    dispatch are confined to the serve fusion layer."""

    id = "fusion-masking"
    reference = "fusion-masking"
    invariant = ("requests are prepared for a fused batch ONLY in "
                 "serve/fusion.py (pad_request_to_bucket is the "
                 "reference's padding with its validity mask; the port "
                 "concatenates its members' rows unpadded) and the "
                 "batched device path torch_engine.fused_aggregate_batch "
                 "(defined in torch_engine.py) is dispatched ONLY from "
                 "serve/fusion.py, so one policy decides which rows "
                 "reach a fused release")
    fix_hint = ("prepare fused batches in pipelinedp_tpu_torch.serve."
                "fusion and dispatch them from serve/fusion.py only")
    blessed = (PKG + "serve/fusion.py",)

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = terminal_name(node.func)
            if name == "pad_request_to_bucket":
                yield (node.lineno,
                       "fused-batch pad-mask construction outside "
                       "serve/fusion.py")
            elif name == "fused_aggregate_batch":
                yield (node.lineno,
                       "batched device path dispatched outside "
                       "serve/fusion.py")


class SketchConfinementRule(Rule):
    """Key hashing and candidate-table construction are confined to
    ``sketch/``; raw builtin ``hash()`` is banned on keys everywhere.

    Python's builtin hash is salted per process (``PYTHONHASHSEED``): a
    key bucketed with it lands in other buckets across runs, resumes and
    mesh ranks, which voids sketch replay and candidate-table stability.
    The seeded stable hash (``sketch/hashing.py``) is the one key hash for
    replayable key-to-bucket maps; ``__hash__`` implementations are exempt
    (dict and set membership is in-process by definition), and in-process
    uses that must follow equality stay on builtin hash() with a reasoned
    suppression."""

    id = "sketch-confinement"
    reference = "sketch-confinement"
    invariant = ("key-to-bucket maps are pure functions of (key bytes, "
                 "seed): raw hash() is process-salted and cannot "
                 "replay; bucket derivation and candidate tables have "
                 "ONE owner (sketch/) so the DP selection's "
                 "sensitivity story cannot fork")
    fix_hint = ("hash keys via pipelinedp_tpu_torch.sketch.hashing "
                "(stable_hash64 / stable_hash_any); build candidate and "
                "bucket tables only inside sketch/")
    blessed = (PKG + "sketch/",)
    _CONFINED_CALLS = frozenset({"bucket_ids", "build_candidate_table"})

    def check(self, ctx):
        for node, func in walk_with_function(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (isinstance(fn, ast.Name) and fn.id == "hash"
                    and func != "__hash__"):
                yield (node.lineno,
                       "raw builtin hash() — process-salted, cannot "
                       "replay; use sketch.hashing.stable_hash_any")
            elif terminal_name(fn) in self._CONFINED_CALLS:
                yield (node.lineno,
                       f"{terminal_name(fn)}() outside sketch/ — "
                       "bucket/candidate-table construction has one "
                       "owner")


class SocketConfinementRule(Rule):
    """Raw wire machinery (``socket`` / ``http.server`` /
    ``socketserver``) is confined to ``obs/http.py``.

    The introspection endpoint is the package's ONE wire surface, read-only
    by construction. A second module opening sockets would grow a second
    listener lifecycle outside the serve drain (orphan accept threads
    survive ``Service.close``). The import ban is the precise form;
    client-side stdlib (``urllib``, ``http.client``) stays free."""

    id = "socket-confinement"
    reference = "socket-confinement"
    invariant = ("the process has ONE wire surface — the read-only "
                 "obs/http.py introspection endpoint, whose accept "
                 "thread the serve lifecycle starts and drains; any "
                 "other socket/http.server/socketserver import grows "
                 "an unmanaged listener")
    fix_hint = ("expose data through pipelinedp_tpu_torch.obs.http "
                "(maybe_start / IntrospectionServer); never open "
                "sockets elsewhere")
    blessed = (PKG + "obs/http.py",)
    _BANNED_MODULES = ("socket", "socketserver", "http.server")

    def check(self, ctx):
        hits = {}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            for name in import_bindings(node):
                if any(name == m or name.startswith(m + ".")
                       for m in self._BANNED_MODULES):
                    hits.setdefault(
                        node.lineno,
                        f"wire-machinery import ({name}) outside "
                        "obs/http.py — the introspection endpoint is "
                        "the one wire surface")
        for line in sorted(hits):
            yield (line, hits[line])


class CollectiveConfinementRule(Rule):
    """``torch.distributed`` collectives, in their module form
    (``dist.all_reduce``) and as a ProcessGroup's methods
    (``pg.allreduce``), are confined to ``parallel/sharded.py``.

    The exchange seam holds three invariants: the exchange ORDER is fixed
    (hier-vs-flat bit-parity rests on both paths reducing through the same
    trees), every exchange is byte-accounted (``comms.ici_bytes`` /
    ``comms.dcn_bytes``), and the ``mesh_topology`` knob steers every
    exchange. A raw collective anywhere else skips all three."""

    id = "collective-confinement"
    reference = "collective-confinement"
    invariant = ("every cross-rank collective goes through "
                 "parallel/sharded.py's helpers (combine_shards / "
                 "gather_blocks / scatter_to_owner / all_reduce_max): ONE "
                 "exchange seam carries the hier-vs-flat parity "
                 "contract, the mesh_topology knob and the byte "
                 "accounting")
    fix_hint = ("call parallel.sharded's exchange helpers instead of "
                "torch.distributed collectives or ProcessGroup methods")
    blessed = (PKG + "parallel/sharded.py",)
    #: ``torch.distributed``'s collectives and a ProcessGroup's methods
    #: (PR 15's exchanges call their group's methods directly).
    _COLLECTIVES = frozenset({
        "all_reduce", "all_gather", "all_gather_into_tensor",
        "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
        "all_to_all", "all_to_all_single", "broadcast",
        "broadcast_object_list", "reduce", "gather", "scatter", "barrier",
        "allreduce", "allgather", "allgather_into_tensor_coalesced",
        "_allgather_base", "_reduce_scatter_base", "alltoall",
        "alltoall_base", "allreduce_coalesced"})
    #: Module-form names that are also common words elsewhere (``reduce``,
    #: ``gather``, ``scatter``, ``broadcast``): flagged only on a
    #: ``dist``/``torch.distributed`` receiver or a group-shaped one.
    _AMBIGUOUS = frozenset({"reduce", "gather", "scatter", "broadcast",
                            "barrier"})

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            name = node.func.attr
            if name not in self._COLLECTIVES:
                continue
            recv = dotted_name(node.func.value) or ""
            last = recv.rsplit(".", 1)[-1].lstrip("_").lower()
            distish = recv in ("dist", "torch.distributed")
            groupish = last in ("pg", "group", "process_group") or (
                last.endswith("_pg") or last.endswith("group"))
            if name in self._AMBIGUOUS and not (distish or groupish):
                continue
            yield (node.lineno,
                   f"raw collective {recv or '<expr>'}.{name}() outside "
                   "parallel/sharded.py — exchanges go through the "
                   "topology-aware seam")
