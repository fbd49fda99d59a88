"""Beam-idiomatic private API (capability parity with the reference's
``pipeline_dp/private_beam.py``): ``MakePrivate`` wraps a PCollection into
a ``PrivatePCollection`` that only releases DP aggregates through typed
``PrivatePTransform``s. A port of ``pipelinedp_tpu/private_beam.py``;
importable only when apache_beam is installed."""

from __future__ import annotations

import abc
import dataclasses
import typing
from typing import Callable, Optional

try:
    import apache_beam as beam
    from apache_beam.transforms import ptransform
except ImportError as _e:  # pragma: no cover
    raise ImportError(
        "pipelinedp_tpu_torch.private_beam requires apache_beam; install "
        "it or use pipelinedp_tpu_torch.private_collection with a local "
        "or Torch backend."
    ) from _e

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import combiners
from pipelinedp_tpu_torch import dp_engine as dp_engine_mod
from pipelinedp_tpu_torch.pipeline_backend import BeamBackend

_beam_backend_singleton = None


def _get_beam_backend() -> BeamBackend:
    """Module-global backend so stage labels stay unique across transforms
    (reference :34-44)."""
    global _beam_backend_singleton
    if _beam_backend_singleton is None:
        _beam_backend_singleton = BeamBackend()
    return _beam_backend_singleton


class PrivatePCollection:
    """A PCollection of (privacy_id, value); only anonymized results can
    leave it (reference :71-94)."""

    def __init__(self, pcol, budget_accountant):
        self._pcol = pcol
        self._budget_accountant = budget_accountant

    def __or__(self, private_transform: "PrivatePTransform"):
        if not isinstance(private_transform, PrivatePTransform):
            raise TypeError(
                "private_transform should be of type PrivatePTransform but "
                f"is {private_transform}")
        private_transform.set_additional_parameters(
            budget_accountant=self._budget_accountant)
        transformed = self._pcol.pipeline.apply(private_transform,
                                                self._pcol)
        return (transformed if private_transform._return_anonymized else
                PrivatePCollection(transformed, self._budget_accountant))


class PrivatePTransform(ptransform.PTransform):
    """Base transform over PrivatePCollections (reference :46-69)."""

    def __init__(self, return_anonymized: bool, label: Optional[str] = None):
        super().__init__(label)
        self._return_anonymized = return_anonymized
        self._budget_accountant = None

    def set_additional_parameters(self, budget_accountant):
        self._budget_accountant = budget_accountant

    def _create_engine(self):
        return dp_engine_mod.DPEngine(self._budget_accountant,
                                      _get_beam_backend())

    @abc.abstractmethod
    def expand(self, pcol):
        pass


class MakePrivate(PrivatePTransform):
    """PCollection -> PrivatePCollection (reference :97-113)."""

    def __init__(self, budget_accountant, privacy_id_extractor: Callable,
                 label: Optional[str] = None):
        super().__init__(return_anonymized=False, label=label)
        self._budget_accountant = budget_accountant
        self._privacy_id_extractor = privacy_id_extractor

    def __rrshift__(self, label):
        self.label = label
        return self

    def expand(self, pcol):
        pcol = pcol | "Extract privacy id" >> beam.Map(
            lambda x: (self._privacy_id_extractor(x), x))
        return PrivatePCollection(pcol, self._budget_accountant)


class _MetricTransform(PrivatePTransform):
    """Shared machinery of the per-metric transforms (each mirrors
    reference :115-427)."""

    METRIC_NAME: typing.ClassVar[str] = ""

    def __init__(self, params, public_partitions=None,
                 label: Optional[str] = None):
        super().__init__(return_anonymized=True, label=label)
        self._params = params
        self._public_partitions = public_partitions

    def expand(self, pcol):
        engine = self._create_engine()
        backend = _get_beam_backend()
        params = self._params
        agg_params = params.to_aggregate_params()
        already = params.contribution_bounds_already_enforced
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=(None if already else lambda row: row[0]),
            partition_extractor=(
                lambda row: params.partition_extractor(row[1])),
            value_extractor=(
                (lambda row: params.value_extractor(row[1]))
                if getattr(params, "value_extractor", None) else
                lambda row: 1),
        )
        result = engine.aggregate(pcol, agg_params, extractors,
                                  self._public_partitions)
        metric = self.METRIC_NAME
        return backend.map_values(result,
                                  lambda mt: getattr(mt, metric),
                                  f"Extract {metric}")


class Count(_MetricTransform):
    METRIC_NAME = "count"


class Sum(_MetricTransform):
    METRIC_NAME = "sum"


class Mean(_MetricTransform):
    METRIC_NAME = "mean"


class Variance(_MetricTransform):
    METRIC_NAME = "variance"


class PrivacyIdCount(_MetricTransform):
    METRIC_NAME = "privacy_id_count"


class SelectPartitions(PrivatePTransform):
    """reference :429-453"""

    def __init__(self, select_partitions_params: agg.SelectPartitionsParams,
                 partition_extractor: Callable,
                 label: Optional[str] = None):
        super().__init__(return_anonymized=True, label=label)
        self._params = select_partitions_params
        self._partition_extractor = partition_extractor

    def expand(self, pcol):
        engine = self._create_engine()
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=lambda row: row[0],
            partition_extractor=(
                lambda row: self._partition_extractor(row[1])))
        return engine.select_partitions(pcol, self._params, extractors)


class Map(PrivatePTransform):
    """Value transform preserving privacy ids (reference :455-465)."""

    def __init__(self, fn: Callable, label: Optional[str] = None):
        super().__init__(return_anonymized=False, label=label)
        self._fn = fn

    def expand(self, pcol):
        return pcol | "map values" >> beam.Map(
            lambda pid_x: (pid_x[0], self._fn(pid_x[1])))


class FlatMap(PrivatePTransform):
    """reference :467-484"""

    def __init__(self, fn: Callable, label: Optional[str] = None):
        super().__init__(return_anonymized=False, label=label)
        self._fn = fn

    def expand(self, pcol):
        return pcol | "flat map values" >> beam.FlatMap(
            lambda pid_x: [(pid_x[0], v) for v in self._fn(pid_x[1])])


class PrivateCombineFn(combiners.CustomCombiner, abc.ABC):
    """Beam-CombineFn-flavored custom combiner (reference :486-549)."""

    @abc.abstractmethod
    def add_input_for_private_output(self, accumulator, input):
        pass

    @abc.abstractmethod
    def extract_private_output(self, accumulator, budget):
        pass

    def create_accumulator(self, values):
        acc = self.create_accumulator_for_private_output()
        for v in values:
            acc = self.add_input_for_private_output(acc, v)
        return acc

    @abc.abstractmethod
    def create_accumulator_for_private_output(self):
        pass

    def compute_metrics(self, accumulator):
        return self.extract_private_output(accumulator, self._budget)


@dataclasses.dataclass
class CombinePerKeyParams:
    """Contribution bounds + budget share for ``CombinePerKey``
    (reference :586-605)."""
    max_partitions_contributed: int
    max_contributions_per_partition: int
    budget_weight: float = 1
    public_partitions: typing.Any = None


class CombinePerKey(PrivatePTransform):
    """Custom-combiner aggregation over (key, value) elements
    (reference :608-649). ``params`` may also be a full
    ``AggregateParams`` carrying ``custom_combiners`` for callers that
    need the extra knobs."""

    def __init__(self, combine_fn: PrivateCombineFn,
                 params: typing.Union[CombinePerKeyParams,
                                      agg.AggregateParams],
                 label: Optional[str] = None):
        super().__init__(return_anonymized=True, label=label)
        self._combine_fn = combine_fn
        self._params = params

    def expand(self, pcol):
        engine = self._create_engine()
        backend = _get_beam_backend()
        public_partitions = None
        if isinstance(self._params, CombinePerKeyParams):
            p = self._params
            public_partitions = p.public_partitions
            params = agg.AggregateParams(
                metrics=None,
                max_partitions_contributed=p.max_partitions_contributed,
                max_contributions_per_partition=(
                    p.max_contributions_per_partition),
                budget_weight=p.budget_weight,
                custom_combiners=[self._combine_fn])
        else:
            params = self._params
            if (not params.custom_combiners or
                    self._combine_fn not in params.custom_combiners):
                raise ValueError(
                    "CombinePerKey got an AggregateParams whose "
                    "custom_combiners do not include the combine_fn; the "
                    "combiner would silently never run.")
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=lambda row: row[0],
            partition_extractor=lambda row: row[1][0],
            value_extractor=lambda row: row[1][1])
        result = engine.aggregate(pcol, params, extractors,
                                  public_partitions)
        if len(params.custom_combiners) == 1:
            # Exactly one combiner -> unwrap its 1-element result tuple
            # (reference :644-646); multi-combiner params keep the tuple.
            result = backend.map_values(result, lambda v: v[0],
                                        "Unnest tuple")
        return result
