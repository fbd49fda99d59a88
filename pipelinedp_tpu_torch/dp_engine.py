"""DPEngine of the port: ``aggregate`` and ``select_partitions`` on the
fused device path.

Port of the entry points of ``pipelinedp_tpu/dp_engine.py`` that this
slice runs: fusable params on a ``TorchBackend`` go to
``torch_engine.build_fused_aggregation`` (``dp_engine.py:294-306`` of the
JAX package) and ``build_fused_select_partitions``. Everything else —
non-fusable params, custom combiners, a backend without the fused path —
raises ``NotImplementedError``: the generic host path is ROADMAP step 2.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from pipelinedp_tpu_torch import report_generator, torch_engine
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams, Metrics,
                                                   SelectPartitionsParams)


@dataclasses.dataclass
class DataExtractors:
    """Extractor triple: given an input row, return its privacy id,
    partition key, and value. Not needed for an ``ArrayDataset``."""
    privacy_id_extractor: Callable = None
    partition_extractor: Callable = None
    value_extractor: Callable = None


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to pipelinedp_tpu_torch yet; the generic "
        "host path is ROADMAP step 2")


class DPEngine:
    """Performs DP aggregations on a ``TorchBackend``."""

    def __init__(self, budget_accountant, backend):
        self._budget_accountant = budget_accountant
        self._backend = backend
        self._report_generators = []

    @property
    def _current_report_generator(self):
        return self._report_generators[-1]

    def explain_computations_report(self):
        return [gen.report() for gen in self._report_generators]

    def _fused_options(self):
        """(rng_seed, device, stream options) of a backend with the fused
        path; raises for any other backend."""
        if not getattr(self._backend, "supports_fused_aggregation", False):
            raise _not_ported(
                f"running on {type(self._backend).__name__} (only "
                "TorchBackend's fused path is)")
        b = self._backend
        return b.rng_seed, b.device, dict(checkpoint=b.checkpoint,
                                          executor=b.ingest_executor,
                                          cache_bytes=b.stream_cache)

    def aggregate(self,
                  col,
                  params: AggregateParams,
                  data_extractors: DataExtractors,
                  public_partitions=None,
                  out_explain_computation_report: Optional[
                      report_generator.ExplainComputationReport] = None):
        """Computes DP metrics per partition key: a lazy collection of
        (partition_key, MetricsTuple), computed when iterated after
        ``budget_accountant.compute_budgets()``."""
        self._check_aggregate_params(col, params, data_extractors)
        if params.custom_combiners:
            raise _not_ported("custom combiners")
        if not torch_engine.params_are_fusable(params):
            raise _not_ported(f"the metrics {params.metrics}")
        rng_seed, device, stream = self._fused_options()
        with self._budget_accountant.scope(weight=params.budget_weight):
            self._report_generators.append(
                report_generator.ReportGenerator(
                    params, "aggregate", public_partitions is not None))
            if out_explain_computation_report is not None:
                out_explain_computation_report._set_report_generator(
                    self._current_report_generator)
            col = torch_engine.build_fused_aggregation(
                col, params, data_extractors, public_partitions,
                self._budget_accountant, self._current_report_generator,
                rng_seed=rng_seed, device=device, stream=stream)
            budget = self._budget_accountant._compute_budget_for_aggregation(
                params.budget_weight)
            return self._backend.annotate(col, "annotation", params=params,
                                          budget=budget)

    def select_partitions(self, col, params: SelectPartitionsParams,
                          data_extractors: DataExtractors):
        """DP set of partition keys present in the data."""
        self._check_select_private_partitions(col, params, data_extractors)
        rng_seed, device, _ = self._fused_options()
        with self._budget_accountant.scope(weight=params.budget_weight):
            self._report_generators.append(
                report_generator.ReportGenerator(params,
                                                 "select_partitions"))
            col = torch_engine.build_fused_select_partitions(
                col, params, data_extractors, self._budget_accountant,
                self._current_report_generator, rng_seed=rng_seed,
                device=device)
            budget = self._budget_accountant._compute_budget_for_aggregation(
                params.budget_weight)
            return self._backend.annotate(col, "annotation", params=params,
                                          budget=budget)

    # ------------------------------------------------------------------
    # validation (as in the JAX package)
    # ------------------------------------------------------------------

    def _check_aggregate_params(self, col, params, data_extractors):
        if params is not None and getattr(params, "max_contributions",
                                          None) is not None:
            unsupported = [m for m in (params.metrics or [])
                           if m.name == "VECTOR_SUM"]
            if unsupported:
                raise NotImplementedError(
                    f"max_contributions does not support {unsupported}")
        if col is None or not col:
            raise ValueError("col must be non-empty")
        if params is None:
            raise ValueError("params must be set to a valid AggregateParams")
        if not isinstance(params, AggregateParams):
            raise TypeError("params must be set to a valid AggregateParams")
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
