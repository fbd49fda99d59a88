"""DPEngine of the port: builds the lazy DP aggregation graph over backend
ops. A copy of ``pipelinedp_tpu/dp_engine.py`` on the port's own modules
(capability parity with the reference's ``pipeline_dp/dp_engine.py``:
``aggregate`` :66, ``select_partitions`` :204, public-partition handling
:283-310, private selection filter :312-362, validation :390-418).

The route is the JAX package's: on a backend with the fused path
(``TorchBackend``), fusable params (``torch_engine.params_are_fusable``)
lower to the fused device path, and ``select_partitions`` always does.
Everything else runs the generic graph of generator chains on the
backend's host ops: custom combiners, a percentile whose range is too
small for the fused walk's float32 leaf constant or that has no
per-value bounds, and every host backend (``LocalBackend``,
``MultiProcLocalBackend``, ``SparkRDDBackend``). The route never depends
on an exception of the fused path. Each aggregation pushes its shape into
the obs audit registry and arms the live monitor under
``PIPELINEDP_TPU_HEARTBEAT``, as in the JAX package. ``aggregate(...,
sketch_first=SketchParams(...))`` takes the two-phase sketch-first path
(``sketch/engine.py``) on a backend with the fused path, and raises
elsewhere, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

from pipelinedp_tpu_torch import (combiners, contribution_bounders,
                                  partition_selection, report_generator,
                                  sampling_utils, torch_engine)
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metrics,
                                                   PartitionSelectionStrategy,
                                                   SelectPartitionsParams)


@functools.lru_cache(maxsize=64)
def _cached_partition_selection_strategy(strategy, eps, delta,
                                         max_partitions, pre_threshold):
    return partition_selection.create_partition_selection_strategy(
        strategy, eps, delta, max_partitions, pre_threshold)


def _selection_filter_fn(budget, max_partitions, max_rows_per_privacy_id,
                         strategy, pre_threshold, row) -> bool:
    """The private-partition-selection predicate, at module level so the
    ``functools.partial`` closing over it pickles to cluster workers.

    Strategy objects are created lazily on workers, after budgets are
    computed (reference :350-352) — but cached per (strategy, eps, delta,
    ...) so the truncated-geometric probability table is built once per
    worker, not per partition."""
    row_count, _ = row[1]
    privacy_id_count = (row_count + max_rows_per_privacy_id -
                        1) // max_rows_per_privacy_id
    strategy_object = _cached_partition_selection_strategy(
        strategy, budget.eps, budget.delta, max_partitions, pre_threshold)
    return strategy_object.should_keep(privacy_id_count)


@dataclasses.dataclass
class DataExtractors:
    """Extractor triple (reference :27-37): given an input row, return its
    privacy id, partition key, and value. Not needed for an
    ``ArrayDataset``."""
    privacy_id_extractor: Callable = None
    partition_extractor: Callable = None
    value_extractor: Callable = None


class DPEngine:
    """Performs DP aggregations (reference :40)."""

    def __init__(self, budget_accountant, backend):
        self._budget_accountant = budget_accountant
        self._backend = backend
        self._report_generators = []

    def rebind_budget_accountant(self, accountant,
                                 reset_reports: bool = True) -> None:
        """Resident-service seam: swap in a fresh per-request budget
        accountant so a warm engine (and with it the backend's built
        kernels) serves many requests instead of one. Batch mode never
        calls this: an engine built the classic way keeps its one
        accountant for life.

        Refuses to swap while the CURRENT accountant still has
        un-finalized mechanisms: those lazy specs are captured by a
        pending lazy result, and rebinding under them would split one
        request's two-phase protocol across two accountants.
        ``reset_reports`` also drops the accumulated explain-report
        generators, which otherwise grow without bound in a resident
        process."""
        if (self._budget_accountant is not None
                and self._budget_accountant._mechanisms
                and not self._budget_accountant.finalized):
            raise RuntimeError(
                "cannot rebind the budget accountant: the current one "
                "has registered mechanisms but compute_budgets() has "
                "not run — finalize (or abandon) the in-flight request "
                "first")
        self._budget_accountant = accountant
        if reset_reports:
            self._report_generators = []

    def clear_budget_accountant(self) -> None:
        """Resident-service seam, failure path: drop a half-run
        accountant (registered mechanisms, never finalized) so the
        warm engine is rebindable again — a same-signature request
        already holding this engine must be served on a fresh
        accountant, not refused over the failed request's leftovers.
        The ledger-side refund/keep decision belongs to the caller."""
        self._budget_accountant = None

    @property
    def _current_report_generator(self):
        return self._report_generators[-1]

    def _add_report_stage(self, stage_description):
        self._current_report_generator.add_stage(stage_description)

    def _add_report_stages(self, stages_description):
        for stage_description in stages_description:
            self._add_report_stage(stage_description)

    def explain_computations_report(self):
        return [gen.report() for gen in self._report_generators]

    def _record_aggregation_audit(self, method: str, params,
                                  public_partitions=None) -> None:
        """Pushes this aggregation's shape into the obs audit registry —
        the run report's ``privacy`` section pairs it with the
        accountant's per-mechanism eps/delta record. Never raises."""
        try:
            from pipelinedp_tpu_torch.obs import audit as obs_audit
            if not obs_audit.audit_enabled():
                return
            rec: dict = {"method": method,
                         "backend": type(self._backend).__name__}
            if isinstance(params, AggregateParams):
                rec["metrics"] = [repr(m) for m in (params.metrics or [])]
                rec["noise_kind"] = (params.noise_kind.value
                                     if params.noise_kind else None)
                rec["contribution_bounds"] = {
                    "max_partitions_contributed":
                        params.max_partitions_contributed,
                    "max_contributions_per_partition":
                        params.max_contributions_per_partition,
                    "max_contributions": params.max_contributions,
                    "min_value": params.min_value,
                    "max_value": params.max_value,
                    "min_sum_per_partition": params.min_sum_per_partition,
                    "max_sum_per_partition": params.max_sum_per_partition,
                }
            rec["budget_weight"] = getattr(params, "budget_weight", None)
            strategy = getattr(params, "partition_selection_strategy",
                               None)
            rec["partition_selection"] = (
                "public" if public_partitions is not None else
                (strategy.value if strategy is not None else None))
            pre_threshold = getattr(params, "pre_threshold", None)
            if pre_threshold is not None:
                rec["pre_threshold"] = pre_threshold
            obs_audit.record_aggregation(rec)
        except Exception:
            pass  # the audit trail must never take an aggregation down

    def explain_computations_structured(self):
        """Machine-readable twin of :meth:`explain_computations_report`:
        one dict per aggregation (method, params string, structured
        stages) — the same stages the string view renders, as data."""
        return [gen.structured() for gen in self._report_generators]

    # ------------------------------------------------------------------
    # aggregate
    # ------------------------------------------------------------------

    def aggregate(self,
                  col,
                  params: AggregateParams,
                  data_extractors: DataExtractors,
                  public_partitions=None,
                  out_explain_computation_report: Optional[
                      report_generator.ExplainComputationReport] = None,
                  sketch_first=None):
        """Computes DP metrics per partition key.

        Returns a collection of (partition_key, MetricsTuple). The graph is
        lazy: execution happens when the caller iterates it, after
        ``budget_accountant.compute_budgets()``.

        ``sketch_first`` (a ``pipelinedp_tpu_torch.sketch.SketchParams``)
        routes through the two-phase unbounded-key path: a device
        counting sketch over hashed keys + DP candidate selection
        (funded by the SketchParams' own (eps, delta)), then this
        engine's exact dense pass over only the selected candidates —
        the partition axis is discovered, never materialized densely.
        Requires the fused backend, privacy ids, fusable metrics and
        private partition selection (no public partitions).
        """
        self._check_aggregate_params(col, params, data_extractors)
        from pipelinedp_tpu_torch import obs
        if sketch_first is not None:
            build = self._sketch_first_builder(params, public_partitions,
                                               sketch_first)
            self._record_aggregation_audit("aggregate_sketch_first", params,
                                           None)
            obs.monitor.maybe_start()
            return self._aggregate_in_scope(
                params, "aggregate_sketch_first", False,
                out_explain_computation_report,
                lambda: build(col, data_extractors))
        self._record_aggregation_audit("aggregate", params,
                                       public_partitions)
        # Live telemetry (PIPELINEDP_TPU_HEARTBEAT): the heartbeat and
        # stall-watchdog monitor; no-op when the knob is off.
        obs.monitor.maybe_start()
        return self._aggregate_in_scope(
            params, "aggregate", public_partitions is not None,
            out_explain_computation_report,
            lambda: self._aggregate(col, params, data_extractors,
                                    public_partitions))

    def _aggregate_in_scope(self, params, method, public, out_report,
                            build):
        """Builds an aggregation's graph with ``build()`` inside the
        accountant's budget scope, with its own report generator, and
        annotates the result."""
        with self._budget_accountant.scope(weight=params.budget_weight):
            self._report_generators.append(
                report_generator.ReportGenerator(params, method, public))
            if out_report is not None:
                out_report._set_report_generator(
                    self._current_report_generator)
            col = build()
            budget = self._budget_accountant._compute_budget_for_aggregation(
                params.budget_weight)
            return self._backend.annotate(col, "annotation", params=params,
                                          budget=budget)

    def _sketch_first_builder(self, params, public_partitions,
                              sketch_params):
        """The two-phase sketch-first path (``sketch/``): checks the entry
        contract now and returns ``build(col, data_extractors)``, which
        builds the graph through
        ``sketch.engine.build_sketch_first_aggregation``."""
        from pipelinedp_tpu_torch.sketch import SketchParams
        from pipelinedp_tpu_torch.sketch import engine as sketch_engine

        if not isinstance(sketch_params, SketchParams):
            raise TypeError("sketch_first must be a "
                            "pipelinedp_tpu_torch.sketch.SketchParams")
        if public_partitions is not None:
            raise ValueError(
                "sketch_first discovers the partition axis — it cannot "
                "be combined with public_partitions (a public axis IS "
                "the dense path)")
        if params.contribution_bounds_already_enforced:
            raise NotImplementedError(
                "sketch_first needs privacy ids for the phase-1 "
                "per-user sketch bounding; "
                "contribution_bounds_already_enforced mode has none")
        fused, rng_seed, device, mesh, stream = (
            self._fused_backend_options())
        if not fused:
            raise NotImplementedError(
                "sketch_first requires the fused backend (TorchBackend) — "
                "host backends never stream an unbounded key axis")
        if not torch_engine.params_are_fusable(params):
            raise NotImplementedError(
                "sketch_first supports only fused-plane metrics "
                "(COUNT / PRIVACY_ID_COUNT / SUM / MEAN / VARIANCE / "
                "VECTOR_SUM / PERCENTILE)")

        def build(col, data_extractors):
            return sketch_engine.build_sketch_first_aggregation(
                col, params, data_extractors, sketch_params,
                self._budget_accountant, self._current_report_generator,
                rng_seed=rng_seed, device=device, stream=stream, mesh=mesh)

        return build

    # Subclasses that swap graph nodes (e.g. the utility-analysis engine)
    # must not take the fused shortcut.
    _supports_fused_dispatch = True

    def _fused_backend_options(self):
        """(fused?, rng_seed, device, mesh, stream options): the one place
        that probes the backend's fused capability and options."""
        if not (self._supports_fused_dispatch and getattr(
                self._backend, "supports_fused_aggregation", False)):
            return False, None, None, None, None
        b = self._backend
        return (True, b.rng_seed, b.device, getattr(b, "mesh", None),
                dict(checkpoint=b.checkpoint, executor=b.ingest_executor,
                     cache_bytes=b.stream_cache))

    def _aggregate(self, col, params, data_extractors, public_partitions):
        fused, rng_seed, device, mesh, stream = (
            self._fused_backend_options())
        if fused and torch_engine.params_are_fusable(params):
            return torch_engine.build_fused_aggregation(
                col, params, data_extractors, public_partitions,
                self._budget_accountant, self._current_report_generator,
                rng_seed=rng_seed, device=device, stream=stream, mesh=mesh)
        if isinstance(col, torch_engine.ArrayDataset):
            col, data_extractors = torch_engine.array_dataset_to_rows(
                col, data_extractors,
                require_pid=not params.contribution_bounds_already_enforced)
        if params.custom_combiners:
            combiner = combiners.create_compound_combiner_with_custom_combiners(
                params, self._budget_accountant, params.custom_combiners)
        else:
            combiner = self._create_compound_combiner(params)

        if public_partitions is not None and (
                not params.public_partitions_already_filtered):
            col = self._drop_not_public_partitions(col, public_partitions,
                                                   data_extractors)
        if not params.contribution_bounds_already_enforced:
            col = self._extract_columns(col, data_extractors)
            # col: (privacy_id, partition_key, value)
            bounder = self._create_contribution_bounder(params)
            col = bounder.bound_contributions(
                col, params, self._backend, self._current_report_generator,
                combiner.create_accumulator)
            # col: ((privacy_id, partition_key), accumulator)
            col = self._backend.map_tuple(
                col, lambda pid_pk, acc: (pid_pk[1], acc), "Drop privacy id")
        else:
            col = self._backend.map(
                col, lambda row: (data_extractors.partition_extractor(row),
                                  data_extractors.value_extractor(row)),
                "Extract (partition_key, value)")
            col = self._backend.map_values(
                col, lambda value: combiner.create_accumulator([value]),
                "Wrap values into accumulators")
        # col: (partition_key, accumulator)

        if public_partitions:
            col = self._add_empty_public_partitions(
                col, public_partitions, combiner.create_accumulator)

        col = self._backend.combine_accumulators_per_key(
            col, combiner, "Reduce accumulators per partition key")

        if public_partitions is None:
            max_rows_per_privacy_id = 1
            if params.contribution_bounds_already_enforced:
                # Without privacy ids, one row is not necessarily one user;
                # ceil(row_count / max_rows_per_privacy_id) lower-bounds the
                # user count (reference :163-169, :341-348).
                max_rows_per_privacy_id = (
                    params.max_contributions or
                    params.max_contributions_per_partition)
            col = self._select_private_partitions_internal(
                col,
                # Total-cap mode: a unit touches <= max_contributions
                # partitions, which is the selection's L0.
                (params.max_partitions_contributed or
                 params.max_contributions),
                max_rows_per_privacy_id,
                params.partition_selection_strategy,
                params.pre_threshold)

        self._add_report_stages(combiner.explain_computation())
        col = self._backend.map_values(col, combiner.compute_metrics,
                                       "Compute DP metrics")
        return col

    # ------------------------------------------------------------------
    # select_partitions
    # ------------------------------------------------------------------

    def select_partitions(self, col, params: SelectPartitionsParams,
                          data_extractors: DataExtractors):
        """DP set of partition keys present in the data (reference :204)."""
        self._check_select_private_partitions(col, params, data_extractors)
        self._record_aggregation_audit("select_partitions", params)

        with self._budget_accountant.scope(weight=params.budget_weight):
            self._report_generators.append(
                report_generator.ReportGenerator(params,
                                                 "select_partitions"))
            col = self._select_partitions(col, params, data_extractors)
            budget = self._budget_accountant._compute_budget_for_aggregation(
                params.budget_weight)
            return self._backend.annotate(col, "annotation", params=params,
                                          budget=budget)

    def _select_partitions(self, col, params, data_extractors):
        fused, rng_seed, device, mesh, _ = self._fused_backend_options()
        if fused:
            return torch_engine.build_fused_select_partitions(
                col, params, data_extractors, self._budget_accountant,
                self._current_report_generator, rng_seed=rng_seed,
                device=device, mesh=mesh)
        max_partitions_contributed = params.max_partitions_contributed
        col = self._backend.map(
            col, lambda row: (data_extractors.privacy_id_extractor(row),
                              data_extractors.partition_extractor(row)),
            "Extract (privacy_id, partition_key)")
        col = self._backend.group_by_key(col, "Group by privacy_id")

        # May be slow if one privacy id contributes to very many partitions
        # (same caveat as reference :247-248).
        def sample_unique_elements_fn(pid_and_pks):
            pid, pks = pid_and_pks
            unique_pks = list(set(pks))
            sampled = sampling_utils.choose_from_list_without_replacement(
                unique_pks, max_partitions_contributed)
            return ((pid, pk) for pk in sampled)

        col = self._backend.flat_map(col, sample_unique_elements_fn,
                                     "Sample cross-partition contributions")

        # An empty compound accumulator tracks the raw privacy-id count.
        compound_combiner = combiners.CompoundCombiner(
            [], return_named_tuple=False)
        col = self._backend.map_tuple(
            col, lambda pid, pk:
            (pk, compound_combiner.create_accumulator([])),
            "Drop privacy id and add accumulator")
        col = self._backend.combine_accumulators_per_key(
            col, compound_combiner, "Combine accumulators per partition key")
        col = self._select_private_partitions_internal(
            col, max_partitions_contributed, max_rows_per_privacy_id=1,
            strategy=params.partition_selection_strategy,
            pre_threshold=params.pre_threshold)
        return self._backend.keys(
            col, "Drop accumulators, keep only partition keys")

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _drop_not_public_partitions(self, col, public_partitions,
                                    data_extractors):
        col = self._backend.map(
            col, lambda row: (data_extractors.partition_extractor(row), row),
            "Extract partition id")
        col = self._backend.filter_by_key(
            col, public_partitions, "Filtering out non-public partitions")
        self._add_report_stage(
            "Public partition selection: dropped non public partitions")
        return self._backend.map_tuple(col, lambda k, v: v, "Drop key")

    def _add_empty_public_partitions(self, col, public_partitions,
                                     aggregator_fn):
        self._add_report_stage(
            "Adding empty partitions for public partitions that are missing "
            "in data")
        public_partitions = self._backend.to_collection(
            public_partitions, col, "Public partitions to collection")
        empty_accumulators = self._backend.map(
            public_partitions,
            lambda pk: (pk, aggregator_fn([])), "Build empty accumulators")
        return self._backend.flatten(
            (col, empty_accumulators),
            "Join public partitions with partitions from data")

    def _select_private_partitions_internal(
            self, col, max_partitions_contributed: int,
            max_rows_per_privacy_id: int,
            strategy: PartitionSelectionStrategy,
            pre_threshold: Optional[int] = None):
        """DP filter keeping only partitions whose (estimated) privacy-id
        count passes the selection strategy (reference :312-362)."""
        budget = self._budget_accountant.request_budget(
            mechanism_type=MechanismType.GENERIC,
            metric="partition_selection")
        # functools.partial over the MODULE-LEVEL _selection_filter_fn:
        # cluster runners pickle this closure to ship it to workers, and
        # only importable functions survive the stdlib pickler (reference
        # :354-357 uses the same construction for the same reason).
        filter_fn = functools.partial(_selection_filter_fn, budget,
                                      max_partitions_contributed,
                                      max_rows_per_privacy_id, strategy,
                                      pre_threshold)
        self._add_report_stage(
            lambda: f"Private Partition selection: using {strategy.value} "
            f"method with (eps={budget.eps}, delta={budget.delta})")
        return self._backend.filter(col, filter_fn,
                                    "Filter private partitions")

    def _create_compound_combiner(
            self, params: AggregateParams) -> combiners.CompoundCombiner:
        return combiners.create_compound_combiner(params,
                                                  self._budget_accountant)

    def _create_contribution_bounder(
            self, params: AggregateParams
    ) -> contribution_bounders.ContributionBounder:
        if params.max_contributions:
            return (contribution_bounders.
                    SamplingPerPrivacyIdContributionBounder())
        return (contribution_bounders.
                SamplingCrossAndPerPartitionContributionBounder())

    def _extract_columns(self, col, data_extractors: DataExtractors):
        return self._backend.map(
            col, lambda row: (data_extractors.privacy_id_extractor(row),
                              data_extractors.partition_extractor(row),
                              data_extractors.value_extractor(row)),
            "Extract (privacy_id, partition_key, value)")

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------

    def _check_aggregate_params(self, col, params, data_extractors,
                                check_data_extractors: bool = True):
        if params is not None and getattr(params, "max_contributions",
                                          None) is not None:
            # The reference declares this parameter end-to-end but its
            # engine rejects it (reference dp_engine.py:395-396); here the
            # total-cap mode is implemented for the scalar metrics and
            # percentiles.
            if params.custom_combiners:
                raise NotImplementedError(
                    "max_contributions is not supported with custom "
                    "combiners (combiners receive no (l0, linf) pair to "
                    "calibrate against)")
            # (PERCENTILE runs under the total cap: the tree noises with
            # the concentration-safe (1, M) sensitivity pair on both
            # planes.)
            unsupported = [
                m for m in (params.metrics or [])
                if m.name == "VECTOR_SUM"
            ]
            if unsupported:
                raise NotImplementedError(
                    f"max_contributions does not support {unsupported} "
                    "(the vector norm-clip sensitivity model has no "
                    "total-cap analogue); use "
                    "(max_partitions_contributed, "
                    "max_contributions_per_partition)")
        if col is None or not col:
            raise ValueError("col must be non-empty")
        if params is None:
            raise ValueError("params must be set to a valid AggregateParams")
        if not isinstance(params, AggregateParams):
            raise TypeError("params must be set to a valid AggregateParams")
        if check_data_extractors:
            if data_extractors is None:
                raise ValueError(
                    "data_extractors must be set to a DataExtractors")
            if not isinstance(data_extractors, DataExtractors):
                raise TypeError(
                    "data_extractors must be set to a DataExtractors")
        if params.contribution_bounds_already_enforced:
            if data_extractors.privacy_id_extractor:
                raise ValueError(
                    "privacy_id_extractor should be set iff "
                    "contribution_bounds_already_enforced is False")
            if Metrics.PRIVACY_ID_COUNT in params.metrics:
                raise ValueError(
                    "PRIVACY_ID_COUNT cannot be computed when "
                    "contribution_bounds_already_enforced is True.")

    def _check_select_private_partitions(self, col, params, data_extractors):
        if col is None or not col:
            raise ValueError("col must be non-empty")
        if params is None:
            raise ValueError(
                "params must be set to a valid SelectPartitionsParams")
        if not isinstance(params, SelectPartitionsParams):
            raise TypeError(
                "params must be set to a valid SelectPartitionsParams")
        if not isinstance(params.max_partitions_contributed,
                          int) or params.max_partitions_contributed <= 0:
            raise ValueError("params.max_partitions_contributed must be set "
                             "(to a positive integer)")
        if data_extractors is None:
            raise ValueError("data_extractors must be set to a "
                             "DataExtractors")
        if not isinstance(data_extractors, DataExtractors):
            raise TypeError("data_extractors must be set to a "
                            "DataExtractors")
